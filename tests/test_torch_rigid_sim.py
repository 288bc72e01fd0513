"""The rigid simulator of the PyTorch port against the JAX package: shapes and
SDFs, each XPBD constraint solve, the substep, and the four rigid golden
trajectories.

Both sides get the same numpy arrays. The states are seeded near contact:
each peg sits partly inside its hole plate, the grippers off their weld
pose, so every branch of the solves runs.

Tolerances (f32 on both sides, differing only in operation order and XLA's
fusion):
- shape sets: exact;
- SDF values: 1e-6 (a handful of f32 operations per value);
- normals: 1e-6 + 1e-7 / |phi|. A normal is (q - q*) / phi, the closest
  boundary point q* subtracted from the query: one f32 rounding of q (~6e-8
  at |q| ~ 0.5; XLA fuses multiply-adds where the port rounds twice) is
  divided by the distance. On the outline itself (|phi| < 1e-6) the normal
  is the rounding residue over 1e-9 and is not compared: no contact acts
  there (a point is in contact where phi < 0);
- one constraint pass, the gyroscopic step and one substep: 1e-5;
- trajectories: the golden gate's own atol 5e-3, rtol 1e-3
  (tests/test_golden_trajectories.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_tpu.sim import shapes as jax_shapes
from geometry_rl_tpu.sim import xpbd as jax_xpbd
from geometry_rl_tpu.sim.types import RigidBodyState as JaxBodies, SceneState as JaxScene
from geometry_rl_torch.convert import rigid_state_from_jax
from geometry_rl_torch.envs import RigidEnvState, make_env
from geometry_rl_torch.sim import shapes, xpbd
from geometry_rl_torch.sim.types import ParticleState, RigidBodyState, SceneState

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SDF_ATOL = 1e-6
SOLVE_ATOL = 1e-5
SHAPE_SETS = {"insertion": shapes.SHAPE_NAMES, "pushing": shapes.PUSHING_SHAPE_NAMES, "sliding": ("L",)}


def to_np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


# ------------------------------------------------------------------ shapes


@pytest.mark.parametrize("clearance", [0.0, 0.08])
@pytest.mark.parametrize("names", sorted(SHAPE_SETS))
def test_shape_set_matches_reference(names, clearance):
    got = shapes.build_shape_set(SHAPE_SETS[names], scale=0.1, half_height=0.05, clearance=clearance)
    ref = jax_shapes.build_shape_set(SHAPE_SETS[names], scale=0.1, half_height=0.05, clearance=clearance)
    for field in ref._fields:
        g, r = getattr(got, field), getattr(ref, field)
        if torch.is_tensor(g):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=field)
        else:
            assert g == r, field
    for name, outline in jax_shapes.SHAPE_OUTLINES.items():
        np.testing.assert_array_equal(shapes.SHAPE_OUTLINES[name], outline)


def assert_normals_close(got, ref, phi, what):
    phi = np.abs(np.asarray(phi))[..., None]
    err = np.abs(np.asarray(got) - np.asarray(ref))
    tol = SDF_ATOL + 1e-7 / np.maximum(phi, 1e-30)
    on_outline = np.broadcast_to(phi < 1e-6, err.shape)
    assert ((err <= tol) | on_outline).all(), (what, err[~on_outline & (err > tol)].max())


def sdf_queries(outlines: np.ndarray, rng) -> np.ndarray:
    """Per-outline query points [S, Q, 2]: uniform in the shape's box, its
    vertices (the padded copies included) and edge midpoints exactly and
    jittered by 1e-4 (where the closest-point ties and the crossing test's
    comparisons decide)."""
    mids = 0.5 * (outlines + np.roll(outlines, -1, axis=1))
    box = rng.uniform(-0.13, 0.13, size=(outlines.shape[0], 64, 2))
    jitter = lambda p: p + rng.normal(scale=1e-4, size=p.shape)  # noqa: E731
    return np.concatenate([box, outlines, mids, jitter(outlines), jitter(mids)], axis=1).astype(np.float32)


@pytest.mark.parametrize("names", sorted(SHAPE_SETS))
def test_polygon_sdfs_match_reference(names):
    ss = jax_shapes.build_shape_set(SHAPE_SETS[names], clearance=0.08)
    outlines = np.array(ss.outline)
    q = sdf_queries(outlines, np.random.default_rng(0))
    phi = shapes.polygon_sdf_2d(torch.as_tensor(q), torch.as_tensor(outlines))
    phi_g, grad = shapes.polygon_sdf_grad_2d(torch.as_tensor(q), torch.as_tensor(outlines))
    ref_phi = jax.vmap(jax_shapes.polygon_sdf_2d)(jnp.asarray(q), jnp.asarray(outlines))
    ref_phi_g, ref_grad = jax.vmap(jax_shapes.polygon_sdf_grad_2d)(jnp.asarray(q), jnp.asarray(outlines))
    assert (np.asarray(ref_phi) < 0).any() and (np.asarray(ref_phi) > 0).any()
    np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi), atol=SDF_ATOL, rtol=0)
    np.testing.assert_allclose(phi_g.numpy(), np.asarray(ref_phi_g), atol=SDF_ATOL, rtol=0)
    assert_normals_close(grad.numpy(), ref_grad, ref_phi_g, "polygon gradient")
    # one unbatched polygon broadcasts the same way
    np.testing.assert_array_equal(shapes.polygon_sdf_2d(torch.as_tensor(q[0]), torch.as_tensor(outlines[0])).numpy(),
                                  phi.numpy()[0])


@pytest.mark.parametrize("names", sorted(SHAPE_SETS))
def test_hole_plate_and_ground_sdfs_match_reference(names):
    ss = jax_shapes.build_shape_set(SHAPE_SETS[names], clearance=0.08)
    outlines = np.array(ss.outline)
    rng = np.random.default_rng(1)
    q = sdf_queries(outlines, rng)
    # z through the plate's faces, its inside and exactly on its top and bottom
    z = rng.choice(np.float32([-0.2, -0.05, -0.03, 0.0, 0.02, 0.05, 0.07]), size=q.shape[:2])
    pts = np.concatenate([q, z[..., None]], axis=-1).astype(np.float32)
    pts = np.concatenate([pts, rng.uniform(-0.5, 0.5, size=(len(outlines), 32, 3)).astype(np.float32)], axis=1)
    kw = dict(plate_half_extent=0.4, plate_top=0.05, plate_bottom=-0.05)
    phi, n = shapes.hole_plate_sdf(torch.as_tensor(pts), torch.as_tensor(outlines), **kw)
    ref_phi, ref_n = jax.vmap(lambda p, o: jax_shapes.hole_plate_sdf(p, o, None, **kw))(jnp.asarray(pts), jnp.asarray(outlines))
    assert (np.asarray(ref_phi) < 0).any() and (np.asarray(ref_phi) > 0).any()
    np.testing.assert_allclose(phi.numpy(), np.asarray(ref_phi), atol=SDF_ATOL, rtol=0)
    assert_normals_close(n.numpy(), ref_n, ref_phi, "plate normal")
    g_phi, g_n = shapes.ground_sdf(torch.as_tensor(pts), 0.01)
    r_phi, r_n = jax_shapes.ground_sdf(jnp.asarray(pts), 0.01)
    np.testing.assert_array_equal(g_phi.numpy(), np.asarray(r_phi))
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(r_n))


# --------------------------------------------------------- the solves


def yaw_quat(yaw):
    return np.stack([np.cos(yaw / 2), np.zeros_like(yaw), np.zeros_like(yaw), np.sin(yaw / 2)], axis=-1)


def tilted(q, rng, scale):
    q = q + rng.normal(scale=scale, size=q.shape)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def near_contact_scene(task: str, seed: int, mild: bool = False):
    """Both envs (8 envs: every insertion shape once) and the same seeded
    scene near contact: (JAX env, port env, JAX SceneState, port SceneState,
    the substep's start positions). Each peg sits partly in its hole plate,
    the grippers are off their weld pose, the pushing stick presses into its
    object. `mild` keeps the state physical (pegs at or above the plate top,
    grippers 1 mm off, slow bodies, the stick 1 cm in): a whole substep of 8
    passes amplifies f32 rounding, and from the deep default state f32 and
    f64 runs of the port already end 3e-4 (insertion) to 2e-2 (two agents)
    apart, while from the mild one they agree to ~1e-6."""
    je = jax_make_env(task, num_envs=8, warmup_steps=0)
    te = make_env(task, num_envs=8, warmup_steps=0, device="cpu")
    rng = np.random.default_rng(seed)
    B, cfg = 8, je.cfg
    obj = cfg.object_body
    off, tilt, speed, z_lo, push = (0.001, 0.005, 0.05, 0.0, -0.34) if mild else (0.01, 0.05, 0.2, -0.06, -0.3)
    tgt_yaw = rng.uniform(-np.pi, np.pi, B)
    tgt_pos = np.stack([np.zeros(B), np.zeros(B), np.full(B, cfg.target_z)], -1)
    obj_pos = tgt_pos + np.stack([rng.uniform(-0.05, 0.05, B), rng.uniform(-0.05, 0.05, B), rng.uniform(z_lo, 0.08, B)], -1)
    obj_q = yaw_quat(tgt_yaw + rng.uniform(-0.3, 0.3, B))
    scene = je._assemble_scene(jnp.asarray(obj_pos, jnp.float32), jnp.asarray(obj_q, jnp.float32),
                               jnp.asarray(tgt_pos, jnp.float32), jnp.asarray(yaw_quat(tgt_yaw), jnp.float32))
    pos = np.array(scene.bodies.pos)
    quat = np.array(scene.bodies.quat)
    G = cfg.num_grippers
    if not cfg.attached:
        pos[:, 0] = pos[:, obj] + np.float32([push, 0.0, 0.0])  # the stick pressed into the object's side
    pos[:, :G] += rng.normal(scale=off, size=(B, G, 3))  # grippers off their weld pose
    quat[:, :G] = tilted(quat[:, :G], rng, tilt)
    quat[:, obj] = tilted(quat[:, obj], rng, tilt / 2.5)
    lin = rng.normal(scale=speed, size=pos.shape)
    ang = rng.normal(scale=2.5 * speed, size=pos.shape)
    prev_pos = pos - 0.01 * lin
    arrays = [a.astype(np.float32) for a in (pos, quat, lin, ang)]
    jscene = JaxScene(bodies=JaxBodies(*(jnp.asarray(a) for a in arrays)))
    tscene = SceneState(bodies=RigidBodyState(*(torch.as_tensor(a) for a in arrays)))
    return je, te, jscene, tscene, prev_pos.astype(np.float32)


@pytest.fixture(scope="module")
def insertion():
    return near_contact_scene("rigid_insertion", 0)


@pytest.fixture(scope="module")
def two_agents():
    return near_contact_scene("rigid_insertion_two_agents", 1)


@pytest.fixture(scope="module")
def pushing():
    return near_contact_scene("rigid_pushing", 2)


def assert_close(got, ref, atol=SOLVE_ATOL, what=""):
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("case", ["insertion", "two_agents"])
def test_fixed_joints_match_reference(case, request):
    """One joint on the object (insertion) and two on it (two agents, where
    each receives half of each correction)."""
    je, te, jscene, tscene, _ = request.getfixturevalue(case)
    assert te.joints.body_b.tolist() == np.asarray(je.joints.body_b).tolist()
    b = jscene.bodies
    jp, jq = jax_xpbd._solve_fixed_joints(b.pos, b.quat, je.body_spec, je.joints)
    tp, tq = xpbd._solve_fixed_joints(tscene.bodies.pos, tscene.bodies.quat, te.body_spec, te.joints)
    assert np.abs(np.asarray(jp) - np.asarray(b.pos)).max() > 1e-3  # the joints moved the bodies
    assert_close(tp, jp, what="pos")
    assert_close(tq, jq, what="quat")


@pytest.mark.parametrize("which", [0, 1], ids=["ground", "plate"])
def test_body_contacts_match_reference(insertion, which):
    je, te, jscene, tscene, prev = insertion
    jc, tc = je._contacts(jscene)[0][which], te._contacts(tscene)[0][which]
    b = jscene.bodies
    # the substep's start pose: the current one, moved back along the velocity
    jprev, tprev = jnp.asarray(prev), torch.as_tensor(prev)
    jp, jq, jl = jax_xpbd._solve_body_contacts(b.pos, b.quat, jprev, b.quat, je.body_spec, jc)
    tp, tq, tl = xpbd._solve_body_contacts(tscene.bodies.pos, tscene.bodies.quat, tprev, tscene.bodies.quat, te.body_spec, tc)
    if which == 1:
        assert (np.asarray(jl) > 0).sum() >= 8  # points in contact with the plate
    assert_close(tl, jl, what="lambda")
    assert_close(tp, jp, what="pos")
    assert_close(tq, jq, what="quat")


def test_body_pair_contact_matches_reference(pushing):
    je, te, jscene, tscene, _ = pushing
    jc, tc = je._contacts(jscene)[1][0], te._contacts(tscene)[1][0]
    b = jscene.bodies
    jp, jq, jl = jax_xpbd._solve_body_pair_contact(b.pos, b.quat, je.body_spec, jc)
    tp, tq, tl = xpbd._solve_body_pair_contact(tscene.bodies.pos, tscene.bodies.quat, te.body_spec, tc)
    assert (np.asarray(jl) > 0).any()
    assert_close(tl, jl, what="lambda")
    assert_close(tp, jp, what="pos")
    assert_close(tq, jq, what="quat")


def test_apply_impulse_matches_reference():
    rng = np.random.default_rng(4)
    B, NB = 6, 4
    pos, r, p = (rng.normal(size=(B, NB, 3)).astype(np.float32) for _ in range(3))
    quat = tilted(np.tile(np.float32([1, 0, 0, 0]), (B, NB, 1)), rng, 0.5).astype(np.float32)
    inv_mass = rng.uniform(0.0, 10.0, NB).astype(np.float32)
    inv_inertia = rng.uniform(0.0, 50.0, (NB, 3)).astype(np.float32)
    free = (rng.uniform(size=(2, NB, 3)) > 0.3).astype(np.float32)
    args = (pos, quat, inv_mass, inv_inertia, free[0], free[1], r, p)
    got = xpbd._apply_impulse(*(torch.as_tensor(a) for a in args))
    ref = jax_xpbd._apply_impulse(*(jnp.asarray(a) for a in args))
    for g, r_, what in zip(got, ref, ("pos", "quat")):
        assert_close(g, r_, what=what)


def test_gyroscopic_step_matches_reference():
    rng = np.random.default_rng(3)
    q = tilted(np.tile(np.float32([1, 0, 0, 0]), (6, 5, 1)), rng, 0.8).astype(np.float32)
    w = rng.normal(scale=3.0, size=(6, 5, 3)).astype(np.float32)
    inv_inertia = rng.uniform(1.0, 50.0, size=(5, 3)).astype(np.float32)
    inv_inertia[3, 1] = 0.0  # a body with a locked axis passes through
    got = xpbd._gyroscopic_step(torch.as_tensor(q), torch.as_tensor(w), torch.as_tensor(inv_inertia), 0.01)
    ref = jax_xpbd._gyroscopic_step(jnp.asarray(q), jnp.asarray(w), jnp.asarray(inv_inertia), 0.01)
    assert np.abs(np.asarray(ref) - w).max() > 1e-3
    assert_close(got, ref)
    np.testing.assert_allclose(got.numpy()[:, 3], w[:, 3], atol=1e-6)


@pytest.mark.parametrize("gyroscopic", [False, True])
@pytest.mark.parametrize("task,seed", [("rigid_insertion", 0), ("rigid_insertion_two_agents", 1), ("rigid_pushing", 2)])
def test_substep_matches_reference(task, seed, gyroscopic):
    je, te, jscene, tscene, _ = near_contact_scene(task, seed, mild=True)
    jc, jpc = je._contacts(jscene)
    tc, tpc = te._contacts(tscene)
    kw = dict(iterations=je.cfg.iterations, gyroscopic=gyroscopic)
    substep = jax.jit(lambda s: jax_xpbd.xpbd_substep(s, je.body_spec, 0.01, joints=je.joints, contacts=jc,
                                                      pair_contacts=jpc, **kw))
    ref = substep(jscene)
    got = xpbd.xpbd_substep(tscene, te.body_spec, 0.01, joints=te.joints, contacts=tc, pair_contacts=tpc, **kw)
    for field in ("pos", "quat"):
        assert_close(getattr(got.bodies, field), getattr(ref.bodies, field), what=field)
    # velocities are recovered from the pose change over dt: the position
    # gate over dt, and 2 x the quaternion gate over dt (w = 2 dq_xyz / dt)
    assert_close(got.bodies.lin_vel, ref.bodies.lin_vel, atol=SOLVE_ATOL / 0.01, what="lin_vel")
    assert_close(got.bodies.ang_vel, ref.bodies.ang_vel, atol=2 * SOLVE_ATOL / 0.01, what="ang_vel")


def test_substep_refuses_what_is_not_ported(insertion):
    """What this test once expected to be refused is ported and runs: a
    contact with restitution goes through the velocity pass, and a scene
    with particles steps them (free fall here: no constraint is given)."""
    _, te, _, tscene, _ = insertion
    plate = te._contacts(tscene)[0][1]  # the pegs sit partly in their plates
    bouncy = xpbd.ContactSet(body=plate.body, local_points=plate.local_points, sdf=plate.sdf, friction=plate.friction,
                             restitution=0.5)
    plain = xpbd.xpbd_substep(tscene, te.body_spec, 0.01, contacts=(plate,))
    out = xpbd.xpbd_substep(tscene, te.body_spec, 0.01, contacts=(bouncy,))
    assert torch.isfinite(out.bodies.lin_vel).all()
    assert torch.equal(out.bodies.pos, plain.bodies.pos)  # the pass acts on velocities only
    assert (out.bodies.lin_vel - plain.bodies.lin_vel).abs().max() > 1e-3
    parts = tscene._replace(particles=ParticleState(pos=torch.zeros(8, 3, 3), vel=torch.zeros(8, 3, 3)))
    out = xpbd.xpbd_substep(parts, te.body_spec, 0.01, particle_spec=xpbd.ParticleSpec(inv_mass=torch.ones(3)))
    np.testing.assert_allclose(out.particles.vel.numpy(), np.broadcast_to(np.float32([0, 0, -0.0981]), (8, 3, 3)), atol=1e-6)
    assert torch.equal(out.bodies.pos, xpbd.xpbd_substep(tscene, te.body_spec, 0.01).bodies.pos)
    assert "NotImplementedError" not in open(xpbd.__file__).read()


# ---------------------------------------------------- golden trajectories

GOLDEN_TASKS = ("rigid_insertion", "rigid_pushing", "rigid_sliding", "rigid_insertion_two_agents")


@pytest.mark.parametrize("task", GOLDEN_TASKS)
def test_golden_trajectory(task):
    """The gate's rollout (tests/test_golden_trajectories.py: 2 envs, no
    warmup, 20 steps of its quasi-random actions) from the JAX reset state."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{task}.npz"))["traj"]
    je = jax_make_env(task, num_envs=2, warmup_steps=0)
    env = make_env(task, num_envs=2, warmup_steps=0, device="cpu")
    state = rigid_state_from_jax(jax.tree_util.tree_map(np.asarray, je.reset(jax.random.PRNGKey(123))),
                                 torch.Generator().manual_seed(0))
    B, A = 2, env.cfg.action_dim
    frames = []
    for t in range(golden.shape[0]):
        action = np.asarray(jnp.sin(jnp.arange(B * A, dtype=jnp.float32).reshape(B, A) * 0.7 + t * 0.3))
        state, _ = env.step(state, torch.as_tensor(action))
        frames.append(state.scene.bodies.pos.numpy().reshape(B, -1))
    np.testing.assert_allclose(np.stack(frames), golden, atol=5e-3, rtol=1e-3)


def test_two_joints_on_one_body_stay_stable():
    """The JAX package's stress fixture (tests/test_sim.py): a real state
    from a diverging two-agent run, which goes NaN within one control step
    without the 1/K joint averaging; 10 steps stay finite and bounded."""
    d = np.load(os.path.join(GOLDEN_DIR, "two_agent_joint_stress.npz"))
    BB = 8  # round-robin: env index == shape id; the fixture is shape 2
    env = make_env("rigid_insertion_two_agents", num_envs=BB, device="cpu")

    def tile(a):
        a = np.asarray(a, np.float32)
        return torch.as_tensor(np.tile(a[None], (BB,) + (1,) * a.ndim))

    state = RigidEnvState(
        scene=SceneState(bodies=RigidBodyState(pos=tile(d["pos"]), quat=tile(d["quat"]), lin_vel=tile(d["lin"]),
                                               ang_vel=tile(d["ang"]))),
        episode_step=torch.full((BB,), int(d["step"]), dtype=torch.int32),
        generator=torch.Generator().manual_seed(0),
        prev_action=torch.zeros((BB, env.cfg.action_dim)),
    )
    action = tile(d["action"])
    for _ in range(10):
        state, _ = env.step(state, action)
    assert torch.isfinite(state.scene.bodies.pos).all(), "two-joint assembly diverged"
    assert state.scene.bodies.pos.abs().max().item() < 10.0
