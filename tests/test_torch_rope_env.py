"""RopeEnv in the PyTorch port against the JAX package's RopeEnv, for rope_closing
and rope_shaping.

Both envs start from the same state (the JAX reset after 2 warm-up steps,
converted) and take the same actions; the runs stay below `episode_length`,
so no reset mixes in (the two packages' random streams cannot agree; the
auto-reset test checks the law of the fresh layout instead).

Tolerances (f32 on both sides, differing in operation order and fusion):
- observations, rewards, the action term and 3 free-running steps: 1e-5 on
  positions, 1e-5 / dt on velocities (position changes over dt = 0.01);
- the shape descriptor on a BENT rope (segment cosines away from +-1): 1e-5;
- the shape descriptor on a straight rope takes `arccos` next to 1, where it
  is ill-conditioned: d(arccos c) = dc / sqrt(1 - c^2). The test computes
  that factor from the reference's own cosines (in f64) and allows 4 f32
  roundings of the cosine (4 x 2^-24) times it; the shaping reward and the
  success distance take the bound this implies for a mean of squares.
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_tpu.envs import rope as jax_rope
from geometry_rl_torch.convert import rope_state_from_jax
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.envs import rope

TASKS = ["rope_closing", "rope_shaping"]
B, L = 4, 12
KW = dict(num_envs=B, num_links=L, rope_length=L * 0.125, warmup_steps=2)
ATOL = 1e-5
VEL_ATOL = ATOL / 0.01
STEPS = 3
F32_EPS = 2.0 ** -24


def np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def port_state(js, seed=0):
    return rope_state_from_jax(np_tree(js), torch.Generator().manual_seed(seed))


def bent_links(rng, batch=B, links=L, spacing=0.1):
    """Chains whose heading turns 0.2-0.6 rad per link, alternating in sign
    at random: every segment cosine lies within [-0.83, 0.98]."""
    turn = rng.uniform(0.2, 0.6, (batch, links - 1)) * rng.choice([-1.0, 1.0], (batch, links - 1))
    heading = np.cumsum(turn, axis=1)
    seg = spacing * np.stack([np.cos(heading), np.sin(heading)], -1)
    xy = np.concatenate([np.zeros((batch, 1, 2)), np.cumsum(seg, axis=1)], axis=1)
    return xy.astype(np.float32)


@pytest.fixture(scope="module", params=TASKS)
def pair(request):
    task = request.param
    je = jax_make_env(task, **KW)
    te = make_env(task, device="cpu", **KW)
    return task, je, te, je.reset(jax.random.PRNGKey(4))


def with_bent_rope(js, seed=3):
    """The state with its rope replaced by a bent one (the reset rope of
    shaping is straight, where the descriptor's arccos is ill-conditioned)."""
    xy = bent_links(np.random.default_rng(seed))
    pos = np.concatenate([xy + np.asarray(js.scene.particles.pos)[:, :1, :2], np.full((B, L, 1), 0.1, np.float32)], -1)
    return js._replace(scene=js.scene._replace(particles=js.scene.particles._replace(pos=jnp.asarray(pos))))


# ------------------------------------------------------------ static pieces


def test_static_layout_and_obs_spec_match_reference(pair):
    task, je, te, _ = pair
    assert te.obs_spec == je.obs_spec
    assert te.cfg.link_spacing == je.cfg.link_spacing and te.cfg.action_dim == je.cfg.action_dim == 6
    assert dataclasses.asdict(te.cfg) == dataclasses.asdict(je.cfg)
    for got, ref in zip(te.body_spec, je.body_spec):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(te.particle_spec.inv_mass.numpy(), np.asarray(je.particle_spec.inv_mass))
    assert te.particle_spec.lin_damping == je.particle_spec.lin_damping
    assert len(te.distance_groups) == len(je.distance_groups) == 2
    for tg, jg in zip(te.distance_groups, je.distance_groups):
        for field in ("i", "j", "rest", "compliance"):
            np.testing.assert_array_equal(getattr(tg, field).numpy(), np.asarray(getattr(jg, field)), err_msg=field)
        assert tg.mask is None and jg.mask is None
    for got, ref in zip(te.attachments, je.attachments):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    if task == "rope_shaping":
        np.testing.assert_array_equal(te.target_curve.numpy(), np.asarray(je.target_curve))
    else:
        assert te.target_curve is None
    obs = te.observe(te.reset(torch.Generator().manual_seed(0)))
    for group, value in obs.items():
        assert value.shape == (B, te.obs_spec.group_dim(group)), group


@pytest.mark.parametrize("task,links,length", [("rope_closing", 40, 5.0), ("rope_shaping", 80, 10.0)])
def test_task_registrations_match_reference(task, links, length):
    jcfg = jax_make_env(task, num_envs=2, warmup_steps=0).cfg
    tcfg = make_env(task, num_envs=2, warmup_steps=0, device="cpu").cfg
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert (tcfg.num_links, tcfg.rope_length, tcfg.is_shaping) == (links, length, task == "rope_shaping")
    assert abs(tcfg.link_spacing - 0.1) < 1e-12


def test_curve_helpers_match_reference():
    for n, length in ((12, 1.5), (80, 10.0)):
        np.testing.assert_array_equal(rope.w_shape_curve(n, length, 0.1), jax_rope.w_shape_curve(n, length, 0.1))
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(3, 7, 3)).astype(np.float32)
    yaw = rng.uniform(-math.pi, math.pi, 3).astype(np.float32)
    np.testing.assert_allclose(rope.yaw_rotate_2d(torch.as_tensor(pts), torch.as_tensor(yaw)).numpy(),
                               np.asarray(jax_rope.yaw_rotate_2d(jnp.asarray(pts), jnp.asarray(yaw))), atol=1e-6)


def test_shape_descriptor_matches_reference_on_a_bent_rope():
    """Batched in the port, `vmap`ped in the reference; [..., L, 2] -> [..., 5L - 3]."""
    xy = bent_links(np.random.default_rng(1), batch=6, links=L)
    ref = np.asarray(jax.vmap(jax_rope.shape_descriptor)(jnp.asarray(xy)))
    got = rope.shape_descriptor(torch.as_tensor(xy))
    assert got.shape == (6, 5 * L - 3)
    seg_angles = ref[:, : L - 2]
    assert seg_angles.min() > 0.15 and seg_angles.max() < 2.6  # cosines away from +-1
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=0)
    # an unbatched polyline, and two batch axes
    np.testing.assert_array_equal(rope.shape_descriptor(torch.as_tensor(xy[0])).numpy(), got.numpy()[0])
    np.testing.assert_array_equal(rope.shape_descriptor(torch.as_tensor(xy.reshape(2, 3, L, 2))).numpy().reshape(6, -1), got.numpy())


def angle_tolerances(xy64: np.ndarray) -> np.ndarray:
    """Per entry of the descriptor of polylines [N, L, 2] (f64), the error
    that 4 f32 roundings of a cosine allow: 4 * 2^-24 / sqrt(1 - c^2) on the
    angle entries (floored at 1e-5), 1e-5 on the others."""
    v = xy64[:, 1:] - xy64[:, :-1]
    unit = v / (np.linalg.norm(v, axis=-1, keepdims=True) + 1e-6)
    g = xy64[:, -1] - xy64[:, 0]
    gunit = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True), 1e-6)
    cos = np.concatenate([(unit[:, :-1] * unit[:, 1:]).sum(-1), (unit * gunit[:, None]).sum(-1)], axis=1)
    cond = 1.0 / np.sqrt(np.maximum(1.0 - np.clip(cos, -1, 1) ** 2, 4 * F32_EPS))
    n_other = 3 * xy64.shape[1]
    return np.concatenate([np.maximum(4 * F32_EPS * cond, ATOL), np.full((len(xy64), n_other), ATOL)], axis=1)


def test_shape_descriptor_on_a_straight_rope_within_its_conditioning():
    """Every segment cosine is 1 / (1 + 1e-5)^2 here (the descriptor divides
    by |v| + 1e-6), where arccos amplifies a cosine's rounding ~160 to 220
    times: the allowed error is derived from the reference's cosines."""
    x = np.arange(L, dtype=np.float32) * np.float32(0.1)
    straight = np.stack([x, np.zeros(L, np.float32)], -1)
    yaws = np.float32([0.0, 0.3, -1.1, 2.0])
    xy = np.stack([np.stack([np.cos(y) * straight[:, 0], np.sin(y) * straight[:, 0]], -1) for y in yaws]).astype(np.float32)
    tol = angle_tolerances(xy.astype(np.float64))
    assert 1e-5 < tol.max() < 2e-4, tol.max()  # what the conditioning allows: a few 1e-5, far under the angles' ~5e-3
    ref = np.asarray(jax.vmap(jax_rope.shape_descriptor)(jnp.asarray(xy)))
    got = rope.shape_descriptor(torch.as_tensor(xy)).numpy()
    assert (np.abs(got - ref) <= tol).all(), np.abs(got - ref).max()


# a LASA .mat file holds its demos' pos as [2, T]; the array formats take any layout
FORMATS = [(fmt, layout) for fmt in ("npy", "npz", "csv", "json", "txt") for layout in ("2xT", "Tx2", "Tx3")] + [("mat", "2xT")]


@pytest.mark.parametrize("fmt,layout", FORMATS)
def test_load_target_curve_formats(tmp_path, fmt, layout):
    rng = np.random.default_rng(5)
    t = np.linspace(0, 1, 37)
    trace = np.stack([t * 3 + 0.1 * rng.normal(size=37), np.sin(4 * t)])  # [2, T]
    data = {"2xT": trace, "Tx2": trace.T, "Tx3": np.concatenate([trace.T, np.ones((37, 1))], axis=1)}[layout]
    path = str(tmp_path / f"curve.{fmt}")
    if fmt == "npy":
        np.save(path, data)
    elif fmt == "npz":
        np.savez(path, curve=data)
    elif fmt == "json":
        with open(path, "w") as f:
            json.dump(data.tolist(), f)
    elif fmt == "mat":
        demos = np.empty((1, 2), dtype=object)
        for d in range(2):
            demos[0, d] = {"pos": trace * (d + 1), "t": t[None]}
        scipy.io.savemat(path, {"demos": demos})
    else:
        np.savetxt(path, data, delimiter=",")
    got = rope.load_target_curve(path, 20, 2.5, 0.1)
    ref = jax_rope.load_target_curve(path, 20, 2.5, 0.1)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (20, 3) and got.dtype == np.float32
    assert abs(np.linalg.norm(np.diff(got[:, :2], axis=0), axis=1).sum() - 2.5) < 1e-5


def test_load_target_curve_rejects_a_bad_shape_and_feeds_the_env(tmp_path):
    np.save(str(tmp_path / "bad.npy"), np.zeros(5))
    with pytest.raises(ValueError, match="must be 2D"):
        rope.load_target_curve(str(tmp_path / "bad.npy"), 10, 1.0)
    t = np.linspace(0, 1, 50)
    path = str(tmp_path / "s.npy")
    np.save(path, np.stack([t, 0.3 * np.sin(6 * t)]))
    kw = dict(KW, target_curve_file=path)
    je, te = jax_make_env("rope_shaping", **kw), make_env("rope_shaping", device="cpu", **kw)
    np.testing.assert_array_equal(te.target_curve.numpy(), np.asarray(je.target_curve))
    assert np.abs(te.target_curve.numpy()[:, :2].mean(0)).max() < 1e-6  # centred


# -------------------------------------------------------- observe and reward


@pytest.mark.parametrize("bent", [False, True], ids=["reset_state", "bent_rope"])
def test_observe_reward_and_action_match_reference(pair, bent):
    """`observe`, `_reward` (the last-steps weights on for half the envs),
    `_target_points` and `_apply_action`."""
    task, je, te, js = pair
    if bent:
        js = with_bent_rope(js)
    ts = port_state(js)
    for group, ref in je.observe(js).items():
        np.testing.assert_allclose(te.observe(ts)[group].numpy(), np.asarray(ref), atol=ATOL, err_msg=group)
    np.testing.assert_allclose(te._target_points(ts).numpy(), np.asarray(je._target_points(js)), atol=1e-6)
    rng = np.random.default_rng(1)
    action = rng.uniform(-1.2, 1.2, (B, 6)).astype(np.float32)
    ep = te.cfg.episode_length
    late = np.asarray([0, ep - 1, 3, ep - (5 if task == "rope_shaping" else 15)], np.int32)
    js_late = js._replace(episode_step=jnp.asarray(late), prev_action=jnp.asarray(rng.uniform(-1, 1, (B, 6)).astype(np.float32)))
    ts_late = port_state(js_late)
    ref = np.asarray(je._reward(js_late, jnp.asarray(action)))
    got = te._reward(ts_late, torch.as_tensor(action)).numpy()
    np.testing.assert_allclose(got, ref, atol=reward_tolerance(task, je, js_late, bent), rtol=1e-6)
    got_b = te._apply_action(ts.scene, torch.as_tensor(action)).bodies
    ref_b = je._apply_action(js.scene, jnp.asarray(action)).bodies
    np.testing.assert_allclose(got_b.lin_vel.numpy(), np.asarray(ref_b.lin_vel), atol=1e-6)
    assert np.abs(got_b.lin_vel.numpy()[..., 2]).max() == 0 and np.abs(got_b.lin_vel.numpy()[..., :2]).max() == 5.0  # clamped, z zeroed
    np.testing.assert_array_equal(got_b.ang_vel.numpy(), np.asarray(ref_b.ang_vel))


def reward_tolerance(task, je, js, bent):
    """1e-5, but for the shaping reward on a straight rope: there the mean of
    squared descriptor differences inherits the angle entries' conditioning,
    |d(mean (a - b)^2)| <= mean(2 |a - b| tol + tol^2), times the last-steps
    weight."""
    if task != "rope_shaping" or bent:
        return ATOL
    cur64 = np.asarray(js.scene.particles.pos, np.float64)[..., :2]
    tgt = np.asarray(je._target_points(js))[..., :2]
    tol = angle_tolerances(cur64) + angle_tolerances(tgt.astype(np.float64))
    diff = np.abs(np.asarray(jax.vmap(jax_rope.shape_descriptor)(js.scene.particles.pos[..., :2]))
                  - np.asarray(jax.vmap(jax_rope.shape_descriptor)(jnp.asarray(tgt))))
    bound = (2 * diff * tol + tol ** 2).mean(axis=-1).max() * je.cfg.shaping_weight_last
    assert bound < 1e-3, bound
    return max(ATOL, bound)


# ----------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def trajectories(pair):
    task, je, te, js = pair
    ts = port_state(js)
    acts = np.random.default_rng(0).uniform(-1.2, 1.2, (STEPS, B, 6)).astype(np.float32)
    out = []
    for t in range(STEPS):
        js, jts = je.step(js, jnp.asarray(acts[t]))
        ts, tts = te.step(ts, torch.as_tensor(acts[t]))
        out.append((js, np_tree((js, jts)), (ts, tts)))
    return out


@pytest.mark.parametrize("step", range(STEPS))
def test_step_matches_reference(pair, trajectories, step):
    task, je, _, _ = pair
    js_raw, (js, jts), (ts, tts) = trajectories[step]
    for name, got, ref, atol in (
        ("links", ts.scene.particles.pos, js.scene.particles.pos, ATOL),
        ("links vel", ts.scene.particles.vel, js.scene.particles.vel, VEL_ATOL),
        ("cubes", ts.scene.bodies.pos, js.scene.bodies.pos, ATOL),
        ("cubes quat", ts.scene.bodies.quat, js.scene.bodies.quat, ATOL),
        ("cubes vel", ts.scene.bodies.lin_vel, js.scene.bodies.lin_vel, VEL_ATOL),
        ("hanger_xy", ts.hanger_xy, js.hanger_xy, 0), ("target_yaw", ts.target_yaw, js.target_yaw, 0),
        ("prev_action", ts.prev_action, js.prev_action, 0),
    ):
        np.testing.assert_allclose(got.numpy(), ref, atol=atol, rtol=0, err_msg=name)
    np.testing.assert_array_equal(ts.episode_step.numpy(), js.episode_step)
    assert ts.episode_step.dtype == torch.int32
    np.testing.assert_array_equal(tts.done.numpy(), jts.done)
    for group, ref in jts.obs.items():
        atol = VEL_ATOL if group == "velocity_vectors" else ATOL
        np.testing.assert_allclose(tts.obs[group].numpy(), ref, atol=atol, err_msg=group)
    # the shaping rope is still nearly straight after 3 steps: its reward and
    # distance take the descriptor's conditioning at this state
    rtol_state = reward_tolerance(task, je, js_raw, bent=False)
    np.testing.assert_allclose(tts.reward.numpy(), jts.reward, atol=rtol_state, rtol=1e-6)
    assert sorted(tts.info) == sorted(jts.info)
    np.testing.assert_array_equal(tts.info["episode_step"].numpy(), jts.info["episode_step"])
    d_ref = jts.info["object_target_distance"]
    # sqrt of the mean square: d(sqrt m) = dm / (2 sqrt m)
    d_tol = ATOL if task == "rope_closing" else max(ATOL, rtol_state / je.cfg.shaping_weight_last / (2 * d_ref.min()))
    np.testing.assert_allclose(tts.info["object_target_distance"].numpy(), d_ref, atol=d_tol)


def test_shaping_distance_matches_reference_on_a_bent_rope():
    """`object_target_distance` (RMS descriptor error) and the reward where
    the descriptor is well-conditioned: 1e-5."""
    je = jax_make_env("rope_shaping", **dict(KW, warmup_steps=0))
    te = make_env("rope_shaping", device="cpu", **dict(KW, warmup_steps=0))
    js = with_bent_rope(je.reset(jax.random.PRNGKey(2)), seed=9)
    # hold the bent rope still: zero action, and compare the pre-physics metric through _shape_error
    ts = port_state(js)
    target = je._target_points(js)
    cur_d = jax.vmap(jax_rope.shape_descriptor)(js.scene.particles.pos[..., :2])
    tgt_d = jax.vmap(jax_rope.shape_descriptor)(target[..., :2])
    ref = np.asarray(jnp.sqrt(jnp.mean((cur_d - tgt_d) ** 2, axis=-1)))
    np.testing.assert_allclose(torch.sqrt(te._shape_error(ts)).numpy(), ref, atol=ATOL, rtol=0)
    action = np.zeros((B, 6), np.float32)
    np.testing.assert_allclose(te._reward(ts, torch.as_tensor(action)).numpy(), np.asarray(je._reward(js, jnp.asarray(action))),
                               atol=ATOL, rtol=0)


# ------------------------------------------------------------- reset's law


def layout_law(env, scene, target_yaw, hanger_xy):
    cfg = env.cfg
    links, cubes = scene.particles.pos, scene.bodies.pos
    n = links.shape[0]
    seg = torch.linalg.vector_norm(links[:, 1:] - links[:, :-1], dim=-1)
    torch.testing.assert_close(seg, torch.full_like(seg, cfg.link_spacing), atol=1e-5, rtol=0)  # a rigid motion of the rest rope
    assert torch.equal(links[..., 2], torch.full_like(links[..., 2], cfg.rope_z))
    assert torch.equal(cubes[..., 2], torch.full_like(cubes[..., 2], cfg.rope_z))
    assert all(torch.count_nonzero(v) == 0 for v in (scene.particles.vel, scene.bodies.lin_vel, scene.bodies.ang_vel))
    assert torch.equal(scene.bodies.quat, torch.tensor([1.0, 0, 0, 0]).expand(n, 2, 4))
    rope_dir = links[:, -1, :2] - links[:, 0, :2]
    rope_yaw = torch.atan2(rope_dir[:, 1], rope_dir[:, 0])
    cube_dir = cubes[:, 1, :2] - cubes[:, 0, :2]
    cube_yaw = torch.atan2(cube_dir[:, 1], cube_dir[:, 0])
    wrap = lambda a: torch.atan2(torch.sin(a), torch.cos(a))  # noqa: E731
    if cfg.is_shaping:
        assert torch.count_nonzero(hanger_xy) == 0
        assert (target_yaw >= cfg.target_yaw_range[0]).all() and (target_yaw < cfg.target_yaw_range[1]).all()
        off = wrap(rope_yaw - target_yaw)
        (lo1, hi1), (lo2, hi2) = cfg.shaping_rot_ranges
        in1 = (off >= lo1 - 1e-5) & (off <= hi1 + 1e-5)
        in2 = (off >= lo2 - 1e-5) & (off <= hi2 + 1e-5)
        assert (in1 | in2).all()
        assert 0.3 < in2.float().mean() < 0.7  # a fair pick between the two ranges
        # cubes on the end links; the rope's center stays where the rest rope's is
        torch.testing.assert_close(cubes, links[:, [0, -1]], atol=1e-5, rtol=0)
        torch.testing.assert_close(links.mean(dim=1), env.rest_center[0].expand(n, 3), atol=1e-5, rtol=0)
    else:
        assert torch.count_nonzero(target_yaw) == 0
        default = torch.tensor(cfg.hanger_pos[:2])
        assert ((hanger_xy - default).abs() <= cfg.hanger_xy_range).all()
        assert (hanger_xy - default).abs().max() > 0.8 * cfg.hanger_xy_range
        # the rope keeps only the second rotation (about the default hanger):
        # its first link lies at distance |hanger| from it, as at rest ...
        torch.testing.assert_close(torch.linalg.vector_norm(links[:, 0, :2] - default, dim=-1),
                                   torch.full((n,), math.hypot(*cfg.hanger_pos[:2])), atol=1e-5, rtol=0)
        # ... while the cubes keep both: their chord is turned against the rope's by yaw1 in +-pi/4
        yaw1 = wrap(cube_yaw - rope_yaw)
        assert (yaw1.abs() <= math.pi / 4 + 1e-5).all() and yaw1.abs().max() > 0.5 * math.pi / 4
        assert rope_yaw.min() < -0.8 * math.pi and rope_yaw.max() > 0.8 * math.pi  # yaw2 spans +-pi
        # the cubes' midpoint is the rope's midpoint (term 1 turns about the center)
        torch.testing.assert_close(cubes.mean(dim=1), links.mean(dim=1), atol=1e-5, rtol=0)
        torch.testing.assert_close(torch.linalg.vector_norm(cube_dir, dim=-1),
                                   torch.full((n,), (cfg.num_links - 1) * cfg.link_spacing), atol=1e-5, rtol=0)


@pytest.mark.parametrize("task", TASKS)
def test_initial_layout_has_the_reference_law(task):
    env = make_env(task, device="cpu", **dict(KW, num_envs=256, warmup_steps=0))
    layout_law(env, *env._initial_layout(torch.Generator().manual_seed(11)))
    # the reference's layout obeys the same law (checked with the same function)
    je = jax_make_env(task, **dict(KW, num_envs=256, warmup_steps=0))
    scene, yaw, hxy = je._initial_layout(jax.random.PRNGKey(11))
    js = port_state(jax_rope.RopeEnvState(scene=scene, target_yaw=yaw, hanger_xy=hxy, episode_step=jnp.zeros(256, jnp.int32),
                                          key=jax.random.PRNGKey(0), prev_action=jnp.zeros((256, 6))))
    layout_law(env, js.scene, js.target_yaw, js.hanger_xy)


@pytest.mark.parametrize("task", TASKS)
def test_done_envs_reset_to_a_fresh_layout(task):
    """Envs that reach the episode's end restart from the layout drawn from
    the state's generator on that step (no warm-up); the others step on."""
    env = make_env(task, device="cpu", **dict(KW, warmup_steps=0, episode_length=3))
    gen = torch.Generator().manual_seed(7)
    state = env.reset(gen)
    state = state._replace(episode_step=torch.tensor([0, 2, 1, 2], dtype=torch.int32))
    action = torch.full((B, 6), 0.3)
    fresh, fresh_yaw, fresh_hxy = env._initial_layout(torch.Generator().manual_seed(0).set_state(gen.get_state()))
    stepped = env._physics(env._apply_action(state.scene, action), state.hanger_xy)
    new, ts = env.step(state, action)
    done = torch.tensor([False, True, False, True])
    assert torch.equal(ts.done, done)
    assert new.episode_step.tolist() == [1, 0, 2, 0]
    assert torch.equal(new.prev_action[done], torch.zeros(2, 6)) and torch.equal(new.prev_action[~done], action[~done])
    for got, f, s in ((new.scene.particles.pos, fresh.particles.pos, stepped.particles.pos),
                      (new.scene.particles.vel, fresh.particles.vel, stepped.particles.vel),
                      (new.scene.bodies.pos, fresh.bodies.pos, stepped.bodies.pos),
                      (new.scene.bodies.lin_vel, fresh.bodies.lin_vel, stepped.bodies.lin_vel),
                      (new.hanger_xy, fresh_hxy, state.hanger_xy), (new.target_yaw, fresh_yaw, state.target_yaw)):
        assert torch.equal(got[done], f[done]) and torch.equal(got[~done], s[~done])
    assert torch.equal(ts.obs["position_vectors"], env.observe(new)["position_vectors"])
    # the success diagnostic is taken before the reset
    if task == "rope_closing":
        d = torch.linalg.vector_norm(stepped.bodies.pos[:, 0, :2] - stepped.bodies.pos[:, 1, :2], dim=-1)
        torch.testing.assert_close(ts.info["object_target_distance"], d)


@pytest.mark.parametrize("task", TASKS)
def test_reset_warms_up_and_is_reproducible(task):
    """`reset` runs `warmup_steps` zero-action steps that zero the bodies'
    velocities only; the same seed gives the same state."""
    env = make_env(task, device="cpu", **dict(KW, warmup_steps=3))
    s1, s2 = env.reset(torch.Generator().manual_seed(3)), env.reset(torch.Generator().manual_seed(3))
    assert torch.equal(s1.scene.particles.pos, s2.scene.particles.pos)
    gen = torch.Generator().manual_seed(3)
    scene, _, hxy = env._initial_layout(gen)
    for _ in range(3):
        zero = torch.zeros_like(scene.bodies.lin_vel)
        scene = env._physics(scene._replace(bodies=scene.bodies._replace(lin_vel=zero, ang_vel=zero)), hxy)
    assert torch.equal(s1.scene.particles.pos, scene.particles.pos)
    assert torch.equal(s1.scene.particles.vel, scene.particles.vel)
    if task == "rope_closing":  # the cubes' offset bends the rope during warm-up
        assert s1.scene.particles.vel.abs().max() > 1e-3
    assert s1.episode_step.dtype == torch.int32 and s1.prev_action.shape == (B, 6)
