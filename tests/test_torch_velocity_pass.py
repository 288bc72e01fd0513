"""The XPBD velocity pass (restitution, dynamic friction) of the PyTorch port
against the JAX package, on the scenes of tests/test_sim.py: a bouncing ball,
a sliding box, particles that bounce and slide, a box landing flat on four
corners, a box on a static body (body pair), opposing walls, and the
co-normal manifold grouping.

Each scene is held two ways:
- substep by substep against the reference: at every substep of the
  reference's own trajectory both packages step the SAME state (the
  reference's), and the port's result is within 1e-5 in positions and
  1e-5 / dt in velocities (velocities are position changes over dt = 0.01).
  A free-running comparison would gate the impact substep's branch
  (`|v_n| > 2 g dt`, `phi < 1e-3`) on f32 rounding instead of the solver;
- free-running in the port alone, with the physical outcome the JAX
  package's own test asserts (rebound at ~e * v_in, stop time ~v0 / (mu g)).

Zero restitution and zero dynamic friction run exactly the ops of a contact
without the fields: bit-equal trajectories, and no velocity-pass function is
called.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_tpu.envs import make_env as jax_make_env
from geometry_rl_tpu.sim import xpbd as jax_xpbd
from geometry_rl_tpu.sim.types import ParticleState as JaxParticles, RigidBodySpec as JaxSpec, \
    RigidBodyState as JaxBodies, SceneState as JaxScene, box_inertia as jax_box_inertia
from geometry_rl_torch.convert import rigid_state_from_jax
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.sim import xpbd
from geometry_rl_torch.sim.types import ParticleState, RigidBodySpec, RigidBodyState, SceneState

B = 2
DT = 0.01
ATOL = 1e-5
CORNERS = np.float32([[-0.05, -0.05, -0.05], [0.05, -0.05, -0.05], [-0.05, 0.05, -0.05], [0.05, 0.05, -0.05]])


def jax_ground(points):
    return points[..., 2], jnp.zeros_like(points).at[..., 2].set(1.0)


def torch_ground(points):
    n = torch.zeros_like(points)
    n[..., 2] = 1.0
    return points[..., 2], n


def jax_table(local_pts):  # static body 1: halfspace with its surface at local z = +0.1
    return local_pts[..., 2] - 0.1, jnp.zeros_like(local_pts).at[..., 2].set(1.0)


def torch_table(local_pts):
    n = torch.zeros_like(local_pts)
    n[..., 2] = 1.0
    return local_pts[..., 2] - 0.1, n


def spec_arrays(inv_mass):
    """Unit boxes (0.1 m) of the given inverse masses; 0 = static."""
    NB = len(inv_mass)
    inertia = np.asarray(1.0 / jax_box_inertia(1.0, (0.1, 0.1, 0.1)))
    return dict(
        inv_mass=np.float32(inv_mass),
        inv_inertia=np.stack([inertia if w > 0 else np.zeros(3) for w in inv_mass]).astype(np.float32),
        gravity_scale=np.float32([1.0 if w > 0 else 0.0 for w in inv_mass]),
        lin_damping=np.zeros(NB, np.float32), ang_damping=np.zeros(NB, np.float32),
        free_pos=np.ones((NB, 3), np.float32), free_rot=np.ones((NB, 3), np.float32),
    )


def body_arrays(pos, lin_vel=None):
    pos = np.tile(np.float32(pos)[None], (B, 1, 1))
    NB = pos.shape[1]
    lin = np.zeros_like(pos) if lin_vel is None else np.tile(np.float32(lin_vel)[None], (B, 1, 1))
    return dict(pos=pos, quat=np.tile(np.float32([1, 0, 0, 0]), (B, NB, 1)), lin_vel=lin, ang_vel=np.zeros_like(pos))


class Scene:
    """One scene in both packages: the state arrays, the body spec, and the
    keyword arguments of `xpbd_substep` for each side."""

    def __init__(self, bodies, spec, jax_kw, torch_kw, steps, particles=None):
        self.bodies, self.particles, self.spec, self.steps = bodies, particles, spec, steps
        self.jax_kw, self.torch_kw = jax_kw, torch_kw
        self.jspec = JaxSpec(**{k: jnp.asarray(v) for k, v in spec.items()})
        self.tspec = RigidBodySpec(**{k: torch.as_tensor(v) for k, v in spec.items()})

    def jax_state(self):
        parts = None if self.particles is None else JaxParticles(*(jnp.asarray(a) for a in self.particles))
        return JaxScene(bodies=JaxBodies(**{k: jnp.asarray(v) for k, v in self.bodies.items()}), particles=parts)

    def torch_state(self, jstate=None):
        if jstate is None:
            jstate = self.jax_state()
        parts = None if jstate.particles is None else ParticleState(*(torch.as_tensor(np.array(a)) for a in jstate.particles))
        return SceneState(bodies=RigidBodyState(*(torch.as_tensor(np.array(a)) for a in jstate.bodies)), particles=parts)

    def torch_step(self, state):
        return xpbd.xpbd_substep(state, self.tspec, DT, **self.torch_kw)


def contact_scene(pos, lin_vel=None, steps=60, points=CORNERS, **material):
    jc = jax_xpbd.ContactSet(body=0, local_points=jnp.asarray(points), sdf=jax_ground, **material)
    tc = xpbd.ContactSet(body=0, local_points=torch.as_tensor(points), sdf=torch_ground, **material)
    return Scene(body_arrays([pos], None if lin_vel is None else [lin_vel]), spec_arrays([1.0]),
                 dict(contacts=(jc,), iterations=4), dict(contacts=(tc,), iterations=4), steps)


def pair_scene(pos, lin_vel=None, steps=80, **material):
    jc = jax_xpbd.BodyPairContact(body_points=0, body_sdf=1, local_points=jnp.asarray(CORNERS), sdf=jax_table, **material)
    tc = xpbd.BodyPairContact(body_points=0, body_sdf=1, local_points=torch.as_tensor(CORNERS), sdf=torch_table, **material)
    lin = None if lin_vel is None else [lin_vel, (0.0, 0.0, 0.0)]
    return Scene(body_arrays([pos, (0.0, 0.0, 0.0)], lin), spec_arrays([1.0, 0.0]),
                 dict(pair_contacts=(jc,), iterations=4), dict(pair_contacts=(tc,), iterations=4), steps)


def particle_scene(steps=60, **material):
    ppos = np.tile(np.float32([[0.0, 0, 0.5], [1.0, 0, 0.001]])[None], (B, 1, 1))
    pvel = np.tile(np.float32([[0.0, 0, 0.0], [1.5, 0, 0.0]])[None], (B, 1, 1))
    spec = spec_arrays([0.0])
    spec["inv_inertia"][:] = 0.0
    jkw = dict(particle_spec=jax_xpbd.ParticleSpec(inv_mass=jnp.ones(2)), iterations=2,
               particle_contacts=(jax_xpbd.ParticleSDFContact(sdf=jax_ground, **material),))
    tkw = dict(particle_spec=xpbd.ParticleSpec(inv_mass=torch.ones(2)), iterations=2,
               particle_contacts=(xpbd.ParticleSDFContact(sdf=torch_ground, **material),))
    return Scene(body_arrays([(0.0, 0.0, 0.0)]), spec, jkw, tkw, steps, particles=(ppos, pvel))


SCENES = {
    "ball_bounce": lambda: contact_scene((0.0, 0.0, 0.5), points=np.float32([[0.0, 0.0, 0.0]]), friction=0.0, restitution=0.8),
    "slider": lambda: contact_scene((0.0, 0.0, 0.05), (2.0, 0.0, 0.0), steps=80, friction=0.0, dynamic_friction=0.4),
    "multi_point": lambda: contact_scene((0.0, 0.0, 0.3), friction=0.0, restitution=0.8),
    "both_knobs": lambda: contact_scene((0.0, 0.0, 0.2), (1.0, 0.5, 0.0), friction=0.3, restitution=0.5, dynamic_friction=0.3),
    "pair_bounce": lambda: pair_scene((0.0, 0.0, 0.6), friction=0.0, restitution=0.8),
    "pair_slider": lambda: pair_scene((0.0, 0.0, 0.15), (2.0, 0.0, 0.0), friction=0.0, dynamic_friction=0.4),
    "particles": lambda: particle_scene(friction=0.0, restitution=0.7, dynamic_friction=0.5),
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_substeps_match_reference(name):
    """Every substep of the reference's trajectory, from the reference's state."""
    scene = SCENES[name]()
    step = jax.jit(lambda s: jax_xpbd.xpbd_substep(s, scene.jspec, DT, **scene.jax_kw))
    jstate = scene.jax_state()
    worst = {}
    for _ in range(scene.steps):
        got = scene.torch_step(scene.torch_state(jstate))
        jstate = step(jstate)
        pairs = [("pos", got.bodies.pos, jstate.bodies.pos, ATOL), ("quat", got.bodies.quat, jstate.bodies.quat, ATOL),
                 ("lin_vel", got.bodies.lin_vel, jstate.bodies.lin_vel, ATOL / DT),
                 ("ang_vel", got.bodies.ang_vel, jstate.bodies.ang_vel, 2 * ATOL / DT)]
        if jstate.particles is not None:
            pairs += [("ppos", got.particles.pos, jstate.particles.pos, ATOL),
                      ("pvel", got.particles.vel, jstate.particles.vel, ATOL / DT)]
        for what, g, r, tol in pairs:
            err = np.abs(g.numpy() - np.asarray(r)).max()
            worst[what] = max(worst.get(what, 0.0), err / tol)
    assert max(worst.values()) <= 1.0, worst


def bounce(scene, read_vz, threshold=0.0):
    """(v_in, v_out) of the first impact of the port's free run."""
    state = scene.torch_state()
    for _ in range(scene.steps):
        prev_vz = read_vz(state)
        state = scene.torch_step(state)
        vz = read_vz(state)
        if prev_vz < -0.5 and vz > threshold:
            return -prev_vz, vz, state
    raise AssertionError("never bounced")


def body_vz(state):
    return state.bodies.lin_vel[0, 0, 2].item()


def test_restitution_ball_bounces():
    v_in, v_out, _ = bounce(SCENES["ball_bounce"](), body_vz)
    assert 0.6 * v_in < v_out < 0.95 * v_in  # ~0.8 but for the impact substep


@pytest.mark.parametrize("name", ["multi_point", "pair_bounce"])
def test_multi_point_restitution_not_amplified(name):
    """Flat on 4 coplanar corners the box rebounds at ~e * v_in, not 4 e v_in."""
    v_in, v_out, state = bounce(SCENES[name](), body_vz)
    assert 0.5 * 0.8 * v_in < v_out <= 0.8 * v_in * 1.05, (v_in, v_out)
    if name == "pair_bounce":  # the static body does not move
        np.testing.assert_allclose(state.bodies.pos[:, 1].numpy(), np.zeros((B, 3)), atol=1e-6)


@pytest.mark.parametrize("name", ["slider", "pair_slider"])
def test_dynamic_friction_decelerates(name):
    """A box sliding at 2 m/s with mu_d = 0.4 stops after ~v0 / (mu g) = 0.51 s."""
    scene = SCENES[name]()
    state, t = scene.torch_state(), 0.0
    for _ in range(200):
        state = scene.torch_step(state)
        t += DT
        if state.bodies.lin_vel[0, 0, 0].item() < 0.05:
            break
    assert 0.3 < t < 0.8, t
    assert abs(state.bodies.lin_vel[0, 0, 0].item()) < 0.3


def test_particle_restitution_and_friction():
    scene = SCENES["particles"]()
    _, _, state = bounce(scene, lambda s: s.particles.vel[0, 0, 2].item(), threshold=0.3)
    assert state.particles.vel[0, 1, 0].item() < 1.0  # the slider lost most of its speed


def test_opposing_wall_restitution_not_cancelled():
    """Two loaded points on opposite channel walls: the approach-side wall
    still reflects the body, and the port's pass equals the reference's."""
    pts = np.float32([[0.05, 0.0, 0.0], [-0.05, 0.0, 0.0]])

    def jax_channel(points):
        x = points[..., 0]
        return 0.05 - jnp.abs(x), jnp.zeros_like(points).at[..., 0].set(-jnp.sign(x))

    def torch_channel(points):
        x = points[..., 0]
        n = torch.zeros_like(points)
        n[..., 0] = -torch.sign(x)
        return 0.05 - torch.abs(x), n

    scene = Scene(body_arrays([(0.0, 0.0, 1.0)]), spec_arrays([1.0]), {}, {}, 0)
    lin = np.zeros((B, 1, 3), np.float32)
    lin[:, 0, 0] = 1.0  # toward the +x wall
    ang = np.zeros((B, 1, 3), np.float32)
    lam = np.full((B, 2), 1e-3, np.float32)  # both walls loaded (press fit)
    pos, quat = scene.bodies["pos"], scene.bodies["quat"]
    jc = jax_xpbd.ContactSet(body=0, local_points=jnp.asarray(pts), sdf=jax_channel, friction=0.0, restitution=0.8)
    tc = xpbd.ContactSet(body=0, local_points=torch.as_tensor(pts), sdf=torch_channel, friction=0.0, restitution=0.8)
    j = [jnp.asarray(a) for a in (lin, ang, pos, quat, pos, quat, lin, ang)]
    t = [torch.as_tensor(a) for a in (lin, ang, pos, quat, pos, quat, lin, ang)]
    ref_v, ref_w = jax_xpbd._velocity_pass_body_contact(*j, scene.jspec, jc, jnp.asarray(lam), DT)
    got_v, got_w = xpbd._velocity_pass_body_contact(*t, scene.tspec, tc, torch.as_tensor(lam), DT)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), atol=ATOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(ref_w), atol=ATOL)
    assert -1.0 <= got_v[0, 0, 0].item() < -0.4  # reflected, without gaining energy


def test_conormal_manifold_grouping():
    """Coplanar normals form one group, orthogonal normals stay apart, and
    inactive points join none; equal to the reference on a seeded input."""
    n = torch.tensor([[[0.0, 0, 1], [0, 0, 1], [1, 0, 0]]])
    lam = torch.tensor([[1.0, 2.0, 4.0]])
    r = torch.tensor([[[1.0, 0, 0], [3.0, 0, 0], [0, 0, 5.0]]])
    cnt, n_bar, lam_tot, (r_bar,) = xpbd._conormal_manifolds(torch.ones(1, 3), n, lam, (r,))
    np.testing.assert_allclose(cnt[0].numpy(), [2.0, 2.0, 1.0])
    np.testing.assert_allclose(lam_tot[0].numpy(), [3.0, 3.0, 4.0])
    np.testing.assert_allclose(r_bar[0, 0].numpy(), [2.0, 0, 0])  # the floor's centroid
    np.testing.assert_allclose(r_bar[0, 2].numpy(), [0, 0, 5.0])  # the wall alone
    np.testing.assert_allclose(n_bar[0, 0].numpy(), [0, 0, 1.0], atol=1e-6)
    np.testing.assert_allclose(n_bar[0, 2].numpy(), [1.0, 0, 0], atol=1e-6)
    cnt2, _, lam2, _ = xpbd._conormal_manifolds(torch.tensor([[1.0, 0.0, 1.0]]), n, lam, (r,))
    np.testing.assert_allclose(cnt2[0].numpy(), [1.0, 1.0, 1.0])  # clamped to >= 1
    np.testing.assert_allclose(lam2[0].numpy(), [1.0, 0.0, 4.0])

    rng = np.random.default_rng(7)
    P = 24
    normals = rng.normal(size=(3, P, 3)) * 0.2 + np.float32([[0, 0, 1], [1, 0, 0], [0, 0, 1]])[rng.integers(0, 3, P)]
    normals = (normals / np.linalg.norm(normals, axis=-1, keepdims=True)).astype(np.float32)
    active = (rng.uniform(size=(3, P)) > 0.3).astype(np.float32)
    lam_n = rng.uniform(0, 1e-2, (3, P)).astype(np.float32)
    vecs = rng.normal(size=(2, 3, P, 3)).astype(np.float32)
    ref = jax_xpbd._conormal_manifolds(jnp.asarray(active), jnp.asarray(normals), jnp.asarray(lam_n), tuple(jnp.asarray(v) for v in vecs))
    got = xpbd._conormal_manifolds(torch.as_tensor(active), torch.as_tensor(normals), torch.as_tensor(lam_n), tuple(torch.as_tensor(v) for v in vecs))
    for g, r_ in zip((*got[:3], *got[3]), (*ref[:3], *ref[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r_), atol=ATOL)


@pytest.mark.parametrize("kind", ["contact", "pair", "particles"])
def test_zero_material_is_a_noop(kind, monkeypatch):
    """restitution = dynamic_friction = 0 given explicitly: the same
    trajectory bit for bit as without the fields, and no velocity-pass
    function runs."""
    for fn in ("_velocity_pass_body_contact", "_velocity_pass_body_pair_contact", "_velocity_pass_particle_contact",
               "_conormal_manifolds"):
        monkeypatch.setattr(xpbd, fn, lambda *a, **k: pytest.fail(f"{fn} ran for a contact with zero material"))
    make = {"contact": lambda **m: contact_scene((0.0, 0.0, 0.3), (0.5, 0.0, 0.0), friction=0.5, **m),
            "pair": lambda **m: pair_scene((0.0, 0.0, 0.3), (0.5, 0.0, 0.0), **m),
            "particles": lambda **m: particle_scene(friction=0.3, **m)}[kind]
    plain, zero = make(), make(restitution=0.0, dynamic_friction=0.0)
    s0, s1 = plain.torch_state(), zero.torch_state()
    for _ in range(100):
        s0, s1 = plain.torch_step(s0), zero.torch_step(s1)
    for a, b in zip((*s0.bodies, *(s0.particles or ())), (*s1.bodies, *(s1.particles or ()))):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert s0.bodies.pos[0, 0, 2].item() < 0.29 or kind == "particles"  # it fell and landed


def test_rigid_env_material_reaches_the_contacts():
    """`restitution` and `dynamic_friction_scale` reach every contact of the
    rigid envs (the dynamic coefficient is the scale times the static one)."""
    for task, n_contacts, n_pairs in (("rigid_insertion", 2, 0), ("rigid_pushing", 1, 1)):
        env = make_env(task, num_envs=4, device="cpu", restitution=0.3, dynamic_friction_scale=1.0)
        plain = make_env(task, num_envs=4, device="cpu")
        state = plain.reset(torch.Generator().manual_seed(0))
        contacts, pairs = env._contacts(state.scene)
        assert (len(contacts), len(pairs)) == (n_contacts, n_pairs)
        for c in (*contacts, *pairs):
            assert c.restitution == 0.3 and c.dynamic_friction == c.friction
        for c in (*plain._contacts(state.scene)[0], *plain._contacts(state.scene)[1]):
            assert c.restitution == 0.0 and c.dynamic_friction == 0.0


def test_rigid_pushing_with_material_matches_reference():
    """rigid_pushing with the material on (the object lies on the ground and
    the stick pushes it: ground and pair contacts both run their velocity
    pass): 6 control steps, each from the reference's state, body positions
    within 1e-4 (4 substeps of 8 passes amplify the 1e-5 of one pass) and
    velocities within 1e-4 / dt; and the material changes the motion."""
    kw = dict(num_envs=4, warmup_steps=2, restitution=0.3, dynamic_friction_scale=1.0)
    je, te = jax_make_env("rigid_pushing", **kw), make_env("rigid_pushing", device="cpu", **kw)
    plain = make_env("rigid_pushing", device="cpu", num_envs=4, warmup_steps=2)
    js = jax.jit(je.reset)(jax.random.PRNGKey(3))
    j_step = jax.jit(je.step)  # jitted: op by op the CPU compiles every primitive apart
    action = np.tile(np.float32([1.0, 0.2, 0.0]), (4, 1))
    differs = 0.0
    for _ in range(6):
        ts = rigid_state_from_jax(jax.tree_util.tree_map(np.asarray, js), torch.Generator().manual_seed(0))
        got, _ = te.step(ts, torch.as_tensor(action))
        without, _ = plain.step(ts, torch.as_tensor(action))
        js, _ = j_step(js, jnp.asarray(action))
        np.testing.assert_allclose(got.scene.bodies.pos.numpy(), np.asarray(js.scene.bodies.pos), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.scene.bodies.quat.numpy(), np.asarray(js.scene.bodies.quat), atol=1e-4, rtol=0)
        np.testing.assert_allclose(got.scene.bodies.lin_vel.numpy(), np.asarray(js.scene.bodies.lin_vel), atol=1e-4 / DT, rtol=0)
        differs = max(differs, (got.scene.bodies.lin_vel - without.scene.bodies.lin_vel).abs().max().item())
    assert differs > 1e-3, differs
