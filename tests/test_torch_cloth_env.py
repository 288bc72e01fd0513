"""ClothEnv in the PyTorch port against the JAX package's ClothEnv.

The JAX env runs its tiled Pallas solve in interpret mode (what `_physics`
selects off the accelerator); the port runs its plain solve on the CPU. Both
start from the same state (the JAX reset, converted) and take the same
actions; no reset mixes in within the 5 steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_torch.convert import cloth_state_from_jax
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.envs.cloth import N_PARTICLES, build_hole_variant, grid_constraints, sample_hole_placements

# the JAX package's own Pallas-vs-XLA gate (tests/test_envs_cloth.py); f32 on
# both sides, differing only in operation order
ATOL = 2e-4
# velocities are (new - prev) / dt, so a few-ulp position gap (~3e-6 after
# one step at |x| ~ 5) is 100x larger in them: they take the position gate / dt
VEL_ATOL = ATOL / 0.01
B = 2
STEPS = 5


@pytest.fixture(scope="module")
def trajectories():
    je = jax_make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver="tiled")
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, device="cpu")
    js = je.reset(jax.random.PRNGKey(5))
    ts_state = cloth_state_from_jax(jax.tree_util.tree_map(np.asarray, js), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        action = rng.uniform(-1.2, 1.2, (B, je.cfg.action_dim)).astype(np.float32)
        js, jts = je.step(js, jnp.asarray(action))
        ts_state, tts = te.step(ts_state, torch.as_tensor(action))
        out.append((jax.tree_util.tree_map(np.asarray, (js, jts)), (ts_state, tts)))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_step_state_matches_reference(trajectories, step):
    (js, _), (ts, _) = trajectories[step]
    pairs = {
        "particles.pos": (js.scene.particles.pos, ts.scene.particles.pos),
        "particles.vel": (js.scene.particles.vel, ts.scene.particles.vel),
        "bodies.pos": (js.scene.bodies.pos, ts.scene.bodies.pos),
        "bodies.lin_vel": (js.scene.bodies.lin_vel, ts.scene.bodies.lin_vel),
        "bodies.ang_vel": (js.scene.bodies.ang_vel, ts.scene.bodies.ang_vel),
        "prev_action": (js.prev_action, ts.prev_action),
    }
    for name, (ref, got) in pairs.items():
        atol = VEL_ATOL if "vel" in name else ATOL
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, err_msg=name)
    np.testing.assert_array_equal(ts.episode_step.numpy(), js.episode_step)


@pytest.mark.parametrize("step", range(STEPS))
def test_step_outputs_match_reference(trajectories, step):
    (_, jts), (_, tts) = trajectories[step]
    np.testing.assert_allclose(tts.reward.numpy(), jts.reward, atol=ATOL)
    np.testing.assert_array_equal(tts.done.numpy(), jts.done)
    for group, ref in jts.obs.items():
        atol = VEL_ATOL if group == "velocity_vectors" else ATOL
        np.testing.assert_allclose(tts.obs[group].numpy(), ref, atol=atol, err_msg=group)
    np.testing.assert_allclose(
        tts.info["object_target_distance"].numpy(), jts.info["object_target_distance"], atol=ATOL
    )


@pytest.mark.parametrize("hole_split", ["train", "test"])
def test_static_layout_matches_reference(hole_split):
    kw = dict(num_envs=3, warmup_steps=0, self_collision=True, hole_split=hole_split)
    je = jax_make_env("cloth_hanging", use_pallas_solver="tiled", **kw)
    te = make_env("cloth_hanging", **kw, device="cpu")
    np.testing.assert_array_equal(te.hole_mask.numpy(), np.asarray(je.hole_mask))
    np.testing.assert_array_equal(te.boundary_idx.numpy(), np.asarray(je.boundary_idx))
    np.testing.assert_array_equal(te.obs_edges.numpy(), np.asarray(je.obs_edges))
    np.testing.assert_array_equal(te.particle_spec.inv_mass.numpy(), np.asarray(je.particle_spec.inv_mass))
    np.testing.assert_array_equal(te.self_pair_mask_full.numpy(), np.asarray(je.self_pair_mask_full))
    np.testing.assert_array_equal(te.self_active_full.numpy(), np.asarray(je.self_active_full))
    assert te.solve_spec == tuple(je.solve_spec)
    assert te.obs_spec == je.obs_spec
    from geometry_rl_tpu.envs import cloth as jax_cloth

    assert sample_hole_placements() == jax_cloth.sample_hole_placements()
    for p in sample_hole_placements()[:5]:
        for a, b in zip(build_hole_variant(p), jax_cloth.build_hole_variant(p)):
            np.testing.assert_array_equal(a, b)
    for (fa, ga), (fb, gb) in zip(grid_constraints(), jax_cloth.grid_constraints()):
        assert fa == fb
        np.testing.assert_array_equal(ga, gb)


def test_area_based_distortion_reward_matches_reference():
    """The triangle-area distortion variant of the reward, on one stepped state."""
    je = jax_make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver="tiled", distortion_area_based=True)
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, distortion_area_based=True, device="cpu")
    js = je.reset(jax.random.PRNGKey(2))
    action = np.random.default_rng(1).uniform(-1, 1, (B, 12)).astype(np.float32)
    stepped = js._replace(scene=je._physics(je._apply_action(js.scene, jnp.asarray(action)), js.hanger_pos))
    ts = cloth_state_from_jax(jax.tree_util.tree_map(np.asarray, stepped), torch.Generator())
    np.testing.assert_allclose(
        te._reward(ts, torch.as_tensor(action)).numpy(), np.asarray(je._reward(stepped, jnp.asarray(action))), atol=ATOL
    )
    np.testing.assert_array_equal(te.tri_mask.numpy(), np.asarray(je.tri_mask))


def test_reset_layout_is_valid():
    """The port's reset draws its own layout (torch's generator, not JAX's
    threefry): corners sit on the gripper cubes, the hanger stays in its box,
    and the cloth keeps its rest shape under the random rigid motion."""
    te = make_env("cloth_hanging", num_envs=8, warmup_steps=0, device="cpu")
    s = te.reset(torch.Generator().manual_seed(1))
    pos = s.scene.particles.pos
    assert pos.shape == (8, N_PARTICLES, 3)
    torch.testing.assert_close(pos[:, te.corner_indices.long()], s.scene.bodies.pos)
    assert (s.hanger_pos[:, [0, 2]] - torch.tensor([0.0, 4.5])).abs().max() <= 0.5
    lengths = te._edge_lengths(pos)
    torch.testing.assert_close(lengths, te.obs_edge_rest.expand_as(lengths), atol=1e-5, rtol=0)


# the reference's solver_mode per setting: "auto" picks the tiled kernel on
# the accelerator (the JAX env on a CPU picks its XLA path instead, which the
# port does not have)
SOLVER_MODES = [("auto", "tiled"), ("tiled", "tiled"), (True, True)]


@pytest.mark.parametrize("mode,expected", SOLVER_MODES)
def test_solver_modes(mode, expected):
    env = make_env("cloth_hanging", num_envs=1, warmup_steps=0, use_pallas_solver=mode, device="cpu")
    assert env.solver_mode == expected and type(env.solver_mode) is type(expected)
    if mode != "auto":
        assert jax_make_env("cloth_hanging", num_envs=1, warmup_steps=0, use_pallas_solver=mode).solver_mode == expected
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_env("cloth_hanging", num_envs=1, use_pallas_solver=False, device="cpu")
    # with the velocity-pass material "auto" means the XLA path, which is not
    # ported; an explicit kernel refuses the material
    with pytest.raises(NotImplementedError if mode == "auto" else ValueError, match="ROADMAP|velocity-pass"):
        make_env("cloth_hanging", num_envs=1, use_pallas_solver=mode, restitution=0.5, device="cpu")


@pytest.mark.parametrize("step", range(2))
def test_per_env_solver_steps_match_reference(step, per_env_trajectories):
    """`use_pallas_solver=True` on both sides: the JAX env runs K1
    (`cloth_position_solve`) in interpret mode, the port the plain version
    that K1's CUDA port is held against on the card."""
    (js, jts), (ts, tts) = per_env_trajectories[step]
    for ref, got, atol in (
        (js.scene.particles.pos, ts.scene.particles.pos, ATOL),
        (js.scene.particles.vel, ts.scene.particles.vel, VEL_ATOL),
        (js.scene.bodies.pos, ts.scene.bodies.pos, ATOL),
        (jts.reward, tts.reward, ATOL),
        (jts.obs["position_vectors"], tts.obs["position_vectors"], ATOL),
    ):
        np.testing.assert_allclose(got.numpy(), ref, atol=atol)


@pytest.fixture(scope="module")
def per_env_trajectories():
    je = jax_make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver=True)
    te = make_env("cloth_hanging", num_envs=B, warmup_steps=0, use_pallas_solver=True, device="cpu")
    assert je.solver_mode is True and te.solver_mode is True
    js = je.reset(jax.random.PRNGKey(6))
    ts_state = cloth_state_from_jax(jax.tree_util.tree_map(np.asarray, js), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        action = rng.uniform(-1.2, 1.2, (B, je.cfg.action_dim)).astype(np.float32)
        js, jts = je.step(js, jnp.asarray(action))
        ts_state, tts = te.step(ts_state, torch.as_tensor(action))
        out.append((jax.tree_util.tree_map(np.asarray, (js, jts)), (ts_state, tts)))
    return out
