"""RigidEnv in the PyTorch port against the JAX package's RigidEnv, for each of
the four task registrations.

Both envs start from the same state (a JAX state, converted) and take the
same actions. The states are stepped from the JAX reset, so they are
physical: f32 on both sides differs only in operation order. Tolerance 1e-5
on positions, observations and rewards over 3 steps (the rigid golden
trajectories of the port and the JAX package agree to ~1e-6 over 20 steps,
tests/test_torch_rigid_sim.py); velocities take it over dt, 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_torch.convert import rigid_state_from_jax
from geometry_rl_torch.envs import RigidEnv, make_env
from geometry_rl_torch.envs.rigid import TASK_REGISTRY

TASKS = sorted(TASK_REGISTRY)
B = 4
ATOL = 1e-5
VEL_ATOL = ATOL / 0.01
STEPS = 3


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def port_state(js, seed=0):
    return rigid_state_from_jax(np_tree(js), torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module", params=TASKS)
def pair(request):
    """Both envs of one task (2 warmup steps) and the JAX reset state."""
    task = request.param
    je = jax_make_env(task, num_envs=B, warmup_steps=2)
    te = make_env(task, num_envs=B, warmup_steps=2, device="cpu")
    return task, je, te, je.reset(jax.random.PRNGKey(4))


def actions(env, seed):
    return np.random.default_rng(seed).uniform(-1.2, 1.2, (B, STEPS, env.cfg.action_dim)).astype(np.float32)


def test_static_layout_and_obs_spec_match_reference(pair):
    _, je, te, _ = pair
    assert te.obs_spec == je.obs_spec
    for name in ("shape_ids", "obj_points", "obj_point_mask", "obj_edges", "obj_surface", "hole_outline", "obj_outline"):
        np.testing.assert_array_equal(getattr(te, name).numpy(), np.asarray(getattr(je, name)), err_msg=name)
    for got, ref in zip(te.body_spec, je.body_spec):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (te.joints is None) == (je.joints is None)
    if te.joints is not None:
        for got, ref in zip(te.joints, je.joints):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    state = te.reset(torch.Generator().manual_seed(0))
    obs = te.observe(state)
    for group, value in obs.items():
        assert value.shape == (B, te.obs_spec.group_dim(group)), group


def test_observe_reward_and_action_match_reference(pair):
    """`observe`, `_reward` (with the last-steps weights on for half the
    envs) and `_apply_action` on the reset state."""
    task, je, te, js = pair
    ts = port_state(js)
    for group, ref in je.observe(js).items():
        np.testing.assert_allclose(te.observe(ts)[group].numpy(), np.asarray(ref), atol=ATOL, err_msg=group)
    action = actions(te, 1)[:, 0]
    late = np.asarray([0, te.cfg.episode_length - 1, 3, te.cfg.episode_length - 2], np.int32)
    js_late = js._replace(episode_step=jnp.asarray(late), prev_action=jnp.asarray(actions(te, 2)[:, 0]))
    ts_late = port_state(js_late)
    np.testing.assert_allclose(te._reward(ts_late, torch.as_tensor(action)).numpy(),
                               np.asarray(je._reward(js_late, jnp.asarray(action))), atol=ATOL, rtol=1e-6)
    got = te._apply_action(ts.scene, torch.as_tensor(action)).bodies
    ref = je._apply_action(js.scene, jnp.asarray(action)).bodies
    for field in ("lin_vel", "ang_vel"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(ref, field)), atol=ATOL, rtol=1e-6,
                                   err_msg=field)


@pytest.fixture(scope="module")
def trajectories(pair):
    task, je, te, js = pair
    ts = port_state(js)
    acts = actions(te, 0)
    out = []
    for t in range(STEPS):
        js, jts = je.step(js, jnp.asarray(acts[:, t]))
        ts, tts = te.step(ts, torch.as_tensor(acts[:, t]))
        out.append((np_tree((js, jts)), (ts, tts)))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference(trajectories, step):
    (js, jts), (ts, tts) = trajectories[step]
    for field in ("pos", "quat", "lin_vel", "ang_vel"):
        atol = VEL_ATOL if "vel" in field else ATOL
        np.testing.assert_allclose(getattr(ts.scene.bodies, field).numpy(), getattr(js.scene.bodies, field), atol=atol,
                                   err_msg=field)
    np.testing.assert_array_equal(ts.episode_step.numpy(), js.episode_step)
    np.testing.assert_array_equal(ts.prev_action.numpy(), js.prev_action)
    np.testing.assert_allclose(tts.reward.numpy(), jts.reward, atol=ATOL)
    np.testing.assert_array_equal(tts.done.numpy(), jts.done)
    for group, ref in jts.obs.items():
        atol = VEL_ATOL if group == "velocity_vectors" else ATOL
        np.testing.assert_allclose(tts.obs[group].numpy(), ref, atol=atol, err_msg=group)
    assert sorted(tts.info) == sorted(jts.info)
    np.testing.assert_array_equal(tts.info["episode_step"].numpy(), jts.info["episode_step"])
    np.testing.assert_allclose(tts.info["object_target_distance"].numpy(), jts.info["object_target_distance"], atol=ATOL)


@pytest.mark.parametrize("task", TASKS)
def test_done_envs_reset_to_fresh_poses(task):
    """Envs that reach the episode's end restart from the poses drawn from the
    state's generator on that step; the others step on. The port draws from
    torch's generator, so the fresh poses are the env's own draw (the
    reference's threefry stream is not reproducible here)."""
    env = make_env(task, num_envs=B, warmup_steps=0, episode_length=3, device="cpu")
    gen = torch.Generator().manual_seed(7)
    state = env.reset(gen)
    state = state._replace(episode_step=torch.tensor([0, 2, 1, 2], dtype=torch.int32))
    action = torch.full((B, env.cfg.action_dim), 0.3)
    expected_fresh = env._assemble_scene(*env._sample_poses(torch.Generator().manual_seed(0).set_state(gen.get_state())))
    stepped = env._physics(env._apply_action(state.scene, action))
    new, ts = env.step(state, action)
    done = torch.tensor([False, True, False, True])
    assert torch.equal(ts.done, done)
    assert new.episode_step.tolist() == [1, 0, 2, 0] and new.episode_step.dtype == torch.int32
    assert torch.equal(new.prev_action[done], torch.zeros(2, env.cfg.action_dim))
    assert torch.equal(new.prev_action[~done], action[~done])
    for field in ("pos", "quat", "lin_vel", "ang_vel"):
        got = getattr(new.scene.bodies, field)
        assert torch.equal(got[done], getattr(expected_fresh.bodies, field)[done]), field
        assert torch.equal(got[~done], getattr(stepped.bodies, field)[~done]), field
    # the success diagnostic is the pre-reset distance
    cfg = env.cfg
    d = torch.linalg.vector_norm(stepped.bodies.pos[:, cfg.object_body] - stepped.bodies.pos[:, cfg.target_body], dim=-1)
    torch.testing.assert_close(ts.info["object_target_distance"], d)
    assert torch.equal(ts.obs["position_vectors"], env.observe(new)["position_vectors"])


def test_reset_draws_valid_poses():
    """The port's reset draws its own poses (torch's generator): inside the
    configured ranges, grippers at their weld pose, and the same draw for the
    same seed."""
    env = make_env("rigid_insertion", num_envs=16, warmup_steps=0, device="cpu")
    s1 = env.reset(torch.Generator().manual_seed(3))
    s2 = env.reset(torch.Generator().manual_seed(3))
    assert torch.equal(s1.scene.bodies.pos, s2.scene.bodies.pos)
    obj = s1.scene.bodies.pos[:, env.cfg.object_body]
    assert (obj[:, :2].abs() <= 1.0).all() and ((obj[:, 2] >= 1.0) & (obj[:, 2] <= 1.5)).all()
    # the weld: gripper anchor and object anchor coincide in the world
    from geometry_rl_torch.utils.math import quat_apply

    b = s1.scene.bodies
    lp_g, lp_o = env.anchors[0]
    torch.testing.assert_close(b.pos[:, 0] + quat_apply(b.quat[:, 0], lp_g), obj + quat_apply(b.quat[:, 1], lp_o))


def test_env_refuses_what_is_not_ported(monkeypatch):
    """The material knobs and the rope tasks, once refused, build and step;
    an unknown task and a missing card still raise."""
    for task, kw in (("rigid_insertion", dict(restitution=0.5)), ("rigid_pushing", dict(dynamic_friction_scale=1.0)),
                     ("rope_closing", dict(num_links=10, rope_length=1.25)), ("rope_shaping", dict(num_links=10, rope_length=1.25))):
        env = make_env(task, num_envs=2, warmup_steps=1, device="cpu", **kw)
        state = env.reset(torch.Generator().manual_seed(0))
        state, ts = env.step(state, torch.zeros(2, env.cfg.action_dim))
        assert torch.isfinite(ts.reward).all() and all(torch.isfinite(v).all() for v in ts.obs.values())
    with pytest.raises(ValueError, match="rope_closing.*rope_shaping"):
        make_env("rope_knotting", num_envs=2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RigidEnv(TASK_REGISTRY["rigid_insertion"](num_envs=2), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_env("rigid_insertion", num_envs=2)
