"""The particle path of the PyTorch port's XPBD solver against the JAX package:
each particle solver function on its own, whole substeps, and the two rope
golden trajectories.

Both sides get the same numpy arrays, made from a seed. The states are
physical: a chain with stretched and slack segments, particles a few
millimetres below the ground and inside the pole, attachments pulled a few
centimetres off their bodies.

Tolerances (f32 on both sides, differing only in operation order and XLA's
fusion):
- one pass of a solver function, and one whole substep: 1e-5 on positions;
  velocities are recovered from the position change over dt = 0.01, so they
  are held to 1e-5 / dt;
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
from geometry_rl_tpu.sim import xpbd as jax_xpbd
from geometry_rl_tpu.sim.shapes import ground_sdf as jax_ground_sdf
from geometry_rl_tpu.sim.types import ParticleState as JaxParticles, RigidBodySpec as JaxSpec, \
    RigidBodyState as JaxBodies, SceneState as JaxScene
from geometry_rl_torch.convert import rope_state_from_jax
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.sim import xpbd
from geometry_rl_torch.sim.shapes import ground_sdf
from geometry_rl_torch.sim.types import ParticleState, RigidBodySpec, RigidBodyState, SceneState

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
ATOL = 1e-5
DT = 0.01


def assert_close(got, ref, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=atol, rtol=0, err_msg=what)


def both(a, dtype=None):
    a = np.asarray(a) if dtype is None else np.asarray(a, dtype)
    return jnp.asarray(a), torch.as_tensor(a)


def tilted_quats(rng, shape, scale=0.3):
    q = np.tile(np.float32([1, 0, 0, 0]), shape + (1,)) + rng.normal(scale=scale, size=shape + (4,))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ distance groups


def chain(rng, B=3, NP=12, spacing=0.1):
    """A chain along +x whose segments are stretched or slack by up to 30%."""
    seg = spacing * rng.uniform(0.7, 1.3, size=(B, NP - 1, 1))
    direction = rng.normal(size=(B, NP - 1, 3)) * 0.3 + np.float32([1, 0, 0])
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    x = np.concatenate([np.zeros((B, 1, 3)), np.cumsum(seg * direction, axis=1)], axis=1)
    return x.astype(np.float32)


@pytest.mark.parametrize("rest_ndim,mask_ndim,mass_ndim", [(1, 0, 1), (2, 1, 2), (1, 2, 2), (2, 2, 1)])
def test_distance_group_matches_reference(rest_ndim, mask_ndim, mass_ndim):
    rng = np.random.default_rng(10 * rest_ndim + 3 * mask_ndim + mass_ndim)
    B, NP = 3, 12
    x = chain(rng, B, NP)
    idx = np.arange(NP - 1)
    for parity in (0, 1):
        i = idx[idx % 2 == parity]
        C = len(i)
        rest = np.full((B, C) if rest_ndim == 2 else (C,), 0.1, np.float32) * rng.uniform(0.9, 1.1, (B, C) if rest_ndim == 2 else (C,)).astype(np.float32)
        compliance = np.where(rng.uniform(size=C) < 0.5, 0.0, 1e-4).astype(np.float32)
        mask = None if mask_ndim == 0 else (rng.uniform(size=(B, C) if mask_ndim == 2 else (C,)) > 0.3).astype(np.float32)
        inv_mass = rng.uniform(5.0, 40.0, (B, NP) if mass_ndim == 2 else (NP,)).astype(np.float32)
        inv_mass[..., 0] = 0.0  # a pinned particle
        (ji, ti), (jj, tj) = both(i, np.int32), both(i + 1, np.int32)
        (jr, tr), (jc, tc), (jw, tw), (jx, tx) = both(rest), both(compliance), both(inv_mass), both(x)
        jm, tm = (None, None) if mask is None else both(mask)
        ref = jax_xpbd._solve_distance_group(jx, jw, jax_xpbd.DistanceGroup(ji, jj, jr, jc, jm), DT)
        got = xpbd._solve_distance_group(tx, tw, xpbd.DistanceGroup(ti, tj, tr, tc, tm), DT)
        assert np.abs(np.asarray(ref) - x).max() > 1e-3  # the group moved the chain
        assert_close(got, ref)
        np.testing.assert_array_equal(got.numpy()[:, 0], x[:, 0])  # the pinned particle stays


# --------------------------------------------------------------- self contact


@pytest.mark.parametrize("active_ndim,mass_ndim", [(0, 1), (1, 2), (2, 2)])
def test_self_contacts_match_reference(active_ndim, mass_ndim):
    rng = np.random.default_rng(20 + active_ndim)
    B, N = 3, 30
    x = rng.uniform(0.0, 0.2, size=(B, N, 3)).astype(np.float32)  # dense: many pairs under min_dist
    pair_mask = (np.abs(np.arange(N)[:, None] - np.arange(N)[None, :]) > 1).astype(np.float32)
    active = None if active_ndim == 0 else (rng.uniform(size=(B, N) if active_ndim == 2 else (N,)) > 0.2).astype(np.float32)
    inv_mass = rng.uniform(5.0, 40.0, (B, N) if mass_ndim == 2 else (N,)).astype(np.float32)
    inv_mass[..., 3] = 0.0
    (jx, tx), (jp, tp), (jw, tw) = both(x), both(pair_mask), both(inv_mass)
    ja, ta = (None, None) if active is None else both(active)
    ref = jax_xpbd._solve_self_contacts(jx, jw, jax_xpbd.ParticleSelfContact(0.05, jp, ja))
    got = xpbd._solve_self_contacts(tx, tw, xpbd.ParticleSelfContact(0.05, tp, ta))
    moved = np.abs(np.asarray(ref) - x).max(axis=-1) > 1e-4
    assert moved.sum() > N  # many particles in violation
    assert_close(got, ref)


# ---------------------------------------------------------------- attachments


def body_spec_arrays(rng, NB, locked=True):
    free_pos = np.ones((NB, 3), np.float32)
    free_rot = np.ones((NB, 3), np.float32)
    if locked:
        free_pos[0, 2] = 0.0  # the rope's cubes: z locked ...
        free_rot[0] = 0.0  # ... and no rotation
        free_rot[1, :2] = 0.0
    return dict(
        inv_mass=rng.uniform(0.05, 2.0, NB).astype(np.float32),
        inv_inertia=rng.uniform(1.0, 50.0, (NB, 3)).astype(np.float32),
        gravity_scale=np.zeros(NB, np.float32),
        lin_damping=np.full(NB, 10.0, np.float32),
        ang_damping=np.full(NB, 10.0, np.float32),
        free_pos=free_pos,
        free_rot=free_rot,
    )


def specs(arrays):
    return JaxSpec(**{k: jnp.asarray(v) for k, v in arrays.items()}), RigidBodySpec(**{k: torch.as_tensor(v) for k, v in arrays.items()})


@pytest.mark.parametrize("batched_local,two_on_one_body", [(False, False), (True, False), (False, True), (True, True)])
def test_attachments_match_reference(batched_local, two_on_one_body):
    """Two-way pins pulled 1-5 cm off; with `two_on_one_body`, body 1 holds
    two attachments, whose corrections must both reach it."""
    rng = np.random.default_rng(30 + 2 * batched_local + two_on_one_body)
    B, NP, NB = 4, 10, 3
    jspec, tspec = specs(body_spec_arrays(rng, NB))
    particle = np.int32([0, 9, 4])
    body = np.int32([0, 1, 1] if two_on_one_body else [0, 1, 2])
    local = rng.uniform(-0.05, 0.05, (B, 3, 3) if batched_local else (3, 3)).astype(np.float32)
    pos = rng.uniform(-1, 1, (B, NB, 3)).astype(np.float32)
    quat = tilted_quats(rng, (B, NB))
    x = rng.uniform(-1, 1, (B, NP, 3)).astype(np.float32)
    # the pinned particles sit near their anchors
    R = np.asarray(jax_xpbd.quat_apply(jnp.asarray(quat[:, body]), jnp.asarray(np.broadcast_to(local, (B, 3, 3)))))
    x[:, particle] = pos[:, body] + R + rng.normal(scale=0.03, size=(B, 3, 3)).astype(np.float32)
    inv_mass = np.full(NP, 20.0, np.float32)
    (jx, tx), (jw, tw), (jp, tp), (jq, tq) = both(x), both(inv_mass), both(pos), both(quat)
    jatt = jax_xpbd.BodyAttachment(*(a for a, _ in (both(particle), both(body), both(local))))
    tatt = xpbd.BodyAttachment(*(a for _, a in (both(particle), both(body), both(local))))
    ref = jax_xpbd._solve_attachments(jx, jw, jp, jq, jspec, jatt)
    got = xpbd._solve_attachments(tx, tw, tp, tq, tspec, tatt)
    assert np.abs(np.asarray(ref[0]) - x).max() > 1e-3 and np.abs(np.asarray(ref[1]) - pos).max() > 1e-4
    for g, r, what in zip(got, ref, ("particles", "body pos", "body quat")):
        assert_close(g, r, what=what)
    np.testing.assert_array_equal(got[1].numpy()[:, 0, 2], pos[:, 0, 2])  # the locked axis
    np.testing.assert_allclose(got[2].numpy()[:, 0], quat[:, 0], atol=2e-7)  # the locked rotation: renormalised only


def test_two_attachments_on_one_body_sum():
    """Seeded check of the scatter itself: with two pins on body 1, its
    correction is the sum of what each pin alone would give (translation
    only: rotation locked)."""
    rng = np.random.default_rng(35)
    B, NP, NB = 2, 6, 2
    arrays = body_spec_arrays(rng, NB, locked=False)
    arrays["free_rot"][:] = 0.0
    _, tspec = specs(arrays)
    pos, quat = torch.as_tensor(rng.uniform(-1, 1, (B, NB, 3)).astype(np.float32)), torch.as_tensor(tilted_quats(rng, (B, NB)))
    x = torch.as_tensor(rng.uniform(-1, 1, (B, NP, 3)).astype(np.float32))
    w = torch.full((NP,), 20.0)
    local = torch.zeros(2, 3)

    def solve(particles, bodies, lp):
        att = xpbd.BodyAttachment(torch.tensor(particles), torch.tensor(bodies), lp)
        return xpbd._solve_attachments(x, w, pos, quat, tspec, att)[1] - pos

    together = solve([1, 4], [1, 1], local)
    alone = solve([1], [1], local[:1]) + solve([4], [1], local[:1])
    np.testing.assert_allclose(together.numpy(), alone.numpy(), atol=1e-6)
    assert together[:, 1].abs().max() > 1e-3 and together[:, 0].abs().max() == 0


# ------------------------------------------------------------ particle contact


def pole_sdfs(hanger_xy, radius=0.15):
    jh, th = both(hanger_xy)

    def jax_pole(points):
        d_xy = points[..., :2] - jh[:, None, :]
        dist = jnp.linalg.norm(d_xy, axis=-1)
        n_xy = d_xy / jnp.maximum(dist, 1e-9)[..., None]
        return dist - radius, jnp.concatenate([n_xy, jnp.zeros_like(points[..., :1])], axis=-1)

    def torch_pole(points):
        d_xy = points[..., :2] - th[:, None, :]
        dist = torch.linalg.vector_norm(d_xy, dim=-1)
        n_xy = d_xy / torch.clamp(dist, min=1e-9)[..., None]
        return dist - radius, torch.cat([n_xy, torch.zeros_like(points[..., :1])], dim=-1)

    return jax_pole, torch_pole


def contact_state(rng, B=3, NP=16):
    """Particles around a pole at the origin and near the ground z = -0.5:
    some inside the pole or below the ground by a few millimetres, each
    having moved ~1 cm during the substep."""
    ang = rng.uniform(-np.pi, np.pi, (B, NP))
    rad = rng.uniform(0.13, 0.18, (B, NP))
    z = rng.uniform(-0.505, -0.49, (B, NP))
    x = np.stack([rad * np.cos(ang), rad * np.sin(ang), z], -1).astype(np.float32)
    prev_x = (x - rng.normal(scale=0.01, size=x.shape)).astype(np.float32)
    return x, prev_x


def jax_particle_contact_pass(x, prev_x, pc):
    """The reference's inline particle-contact pass (xpbd_substep's iteration body)."""
    phi, n = pc.sdf(x)
    pen = jnp.minimum(phi, 0.0)
    dx_n = -pen[..., None] * n
    disp = x - prev_x
    disp_t = disp - jnp.sum(disp * n, axis=-1, keepdims=True) * n
    t_norm = jnp.linalg.norm(disp_t, axis=-1, keepdims=True)
    scale = jnp.minimum(1.0, pc.friction * (-pen[..., None]) / jnp.maximum(t_norm, 1e-9))
    active = (phi < 0.0).astype(x.dtype)[..., None]
    return x + active * (dx_n - scale * disp_t), -pen


@pytest.mark.parametrize("which", ["ground", "pole"])
def test_particle_contact_matches_reference(which):
    rng = np.random.default_rng(40)
    x, prev_x = contact_state(rng)
    jpole, tpole = pole_sdfs(np.zeros((3, 2), np.float32))
    if which == "ground":
        jpc = jax_xpbd.ParticleSDFContact(sdf=lambda p: jax_ground_sdf(p, -0.5), friction=0.3)
        tpc = xpbd.ParticleSDFContact(sdf=lambda p: ground_sdf(p, -0.5), friction=0.3)
    else:
        jpc = jax_xpbd.ParticleSDFContact(sdf=jpole, friction=0.4)
        tpc = xpbd.ParticleSDFContact(sdf=tpole, friction=0.4)
    ref_x, ref_depth = jax_particle_contact_pass(jnp.asarray(x), jnp.asarray(prev_x), jpc)
    got_x, got_depth = xpbd._solve_particle_contact(torch.as_tensor(x), torch.as_tensor(prev_x), tpc)
    assert (np.asarray(ref_depth) > 1e-3).sum() >= 5  # particles in contact
    assert_close(got_x, ref_x, what="x")
    assert_close(got_depth, ref_depth, what="depth")


# ------------------------------------------------------------ whole substeps


def rope_scene(task, seed, B=3, L=12):
    """Both rope envs and one physical state: a gently bent chain lying at
    its spacing with small stretch, the cubes 1 cm off the end links, slow
    velocities, and (closing) the pole pressed ~1 cm into the rope's middle."""
    kw = dict(num_envs=B, num_links=L, rope_length=L * 0.125, warmup_steps=0)
    je, te = jax_make_env(task, **kw), make_env(task, device="cpu", **kw)
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(scale=0.15, size=(B, L - 1)), axis=1)
    seg = 0.1 * rng.uniform(0.97, 1.03, (B, L - 1, 1)) * np.stack([np.cos(heading), np.sin(heading), np.zeros_like(heading)], -1)
    links = np.concatenate([np.zeros((B, 1, 3)), np.cumsum(seg, axis=1)], axis=1) + np.float32([0, 0, 0.1])
    cubes = links[:, [0, L - 1]] + rng.normal(scale=0.01, size=(B, 2, 3)) * np.float32([1, 1, 0])
    mid = links[:, L // 2, :2]
    hanger_xy = mid + (0.15 - 0.01) * np.stack([-np.sin(heading[:, L // 2 - 1]), np.cos(heading[:, L // 2 - 1])], -1)
    arrays = dict(
        pos=cubes, quat=np.tile(np.float32([1, 0, 0, 0]), (B, 2, 1)), lin_vel=rng.normal(scale=0.5, size=(B, 2, 3)) * np.float32([1, 1, 0]),
        ang_vel=np.zeros((B, 2, 3)), ppos=links, pvel=rng.normal(scale=0.2, size=(B, L, 3)),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    jscene = JaxScene(bodies=JaxBodies(*(jnp.asarray(arrays[k]) for k in ("pos", "quat", "lin_vel", "ang_vel"))),
                      particles=JaxParticles(jnp.asarray(arrays["ppos"]), jnp.asarray(arrays["pvel"])))
    tscene = SceneState(bodies=RigidBodyState(*(torch.as_tensor(arrays[k]) for k in ("pos", "quat", "lin_vel", "ang_vel"))),
                        particles=ParticleState(torch.as_tensor(arrays["ppos"]), torch.as_tensor(arrays["pvel"])))
    return je, te, jscene, tscene, hanger_xy.astype(np.float32)


def assert_scene_close(got, ref):
    assert_close(got.particles.pos, ref.particles.pos, what="particles")
    assert_close(got.bodies.pos, ref.bodies.pos, what="body pos")
    assert_close(got.bodies.quat, ref.bodies.quat, what="body quat")
    assert_close(got.particles.vel, ref.particles.vel, atol=ATOL / DT, what="particle vel")
    assert_close(got.bodies.lin_vel, ref.bodies.lin_vel, atol=ATOL / DT, what="body vel")


@pytest.mark.parametrize("task,seed", [("rope_closing", 50), ("rope_shaping", 51)])
def test_rope_substep_matches_reference(task, seed):
    """One control step's physics (2 substeps of 8 iterations: both distance
    groups, the attachments, ground and pole) from a seeded physical state."""
    je, te, jscene, tscene, hxy = rope_scene(task, seed)
    ref = jax.jit(je._physics)(jscene, jnp.asarray(hxy))
    got = te._physics(tscene, torch.as_tensor(hxy))
    if task == "rope_closing":
        phi, _ = te._particle_contacts(torch.as_tensor(hxy))[1].sdf(tscene.particles.pos)
        assert (phi < 0).any()  # the pole is in contact
    assert np.abs(np.asarray(ref.particles.pos) - tscene.particles.pos.numpy()).max() > 1e-3
    assert_scene_close(got, ref)


def test_cloth_substep_with_self_contact_matches_reference():
    """One substep of the cloth scene through `xpbd_substep`: 12 masked
    distance groups, the all-pairs self contact, four attachments and the
    hook capsule, from the JAX reset state after two warm-up steps."""
    kw = dict(num_envs=2, warmup_steps=2, use_pallas_solver=False, self_collision=True, self_collision_distance=0.09)
    je, te = jax_make_env("cloth_hanging", **kw), make_env("cloth_hanging", device="cpu", **kw)
    js = je.reset(jax.random.PRNGKey(5))
    # fold the sheet a little so that non-neighbour particles come under min_dist
    ppos = np.array(js.scene.particles.pos)
    ppos = ppos + 0.3 * (ppos.mean(axis=1, keepdims=True) - ppos) * (np.arange(225) % 2)[None, :, None]
    jscene = js.scene._replace(particles=js.scene.particles._replace(pos=jnp.asarray(ppos)))
    tscene = SceneState(bodies=RigidBodyState(*(torch.as_tensor(np.array(a)) for a in jscene.bodies)),
                        particles=ParticleState(*(torch.as_tensor(np.array(a)) for a in jscene.particles)))
    hanger = np.array(js.hanger_pos)
    kwj = dict(particle_spec=je.particle_spec, distance_groups=je.distance_groups, attachments=je.attachments,
               particle_contacts=je._hanger_contacts(jnp.asarray(hanger)), self_contacts=je.self_contacts, iterations=2)
    kwt = dict(particle_spec=te.particle_spec, distance_groups=te.distance_groups, attachments=te.attachments,
               particle_contacts=te._hanger_contacts(torch.as_tensor(hanger)), self_contacts=te.self_contacts, iterations=2)
    sc = te.self_contacts[0]
    with_sc = xpbd._solve_self_contacts(tscene.particles.pos, te.particle_spec.inv_mass, sc)
    assert (with_sc - tscene.particles.pos).abs().max() > 1e-3  # the self contact acts
    ref = jax.jit(lambda s: jax_xpbd.xpbd_substep(s, je.body_spec, DT, **kwj))(jscene)
    got = xpbd.xpbd_substep(tscene, te.body_spec, DT, **kwt)
    assert_scene_close(got, ref)


def test_substep_without_particles_passes_them_through():
    """No `particle_spec`: the particles are returned as they came (the
    reference's `else` branch), and the bodies step as in the rigid subset."""
    _, te, _, tscene, _ = rope_scene("rope_closing", 52)
    out = xpbd.xpbd_substep(tscene, te.body_spec, DT)
    assert out.particles is tscene.particles
    assert (out.bodies.pos - tscene.bodies.pos).abs().max() > 1e-4


# ---------------------------------------------------- golden trajectories


@pytest.mark.parametrize("task", ["rope_closing", "rope_shaping"])
def test_golden_trajectory(task):
    """The gate's rollout (tests/test_golden_trajectories.py: 2 envs, 20
    links, length 2.5, no warm-up, 20 steps of its quasi-random actions) from
    the JAX reset state."""
    golden = np.load(os.path.join(GOLDEN_DIR, f"{task}.npz"))["traj"]
    kw = dict(num_envs=2, num_links=20, rope_length=2.5, warmup_steps=0)
    je = jax_make_env(task, **kw)
    env = make_env(task, device="cpu", **kw)
    state = rope_state_from_jax(jax.tree_util.tree_map(np.asarray, je.reset(jax.random.PRNGKey(123))),
                                torch.Generator().manual_seed(0))
    B, A = 2, env.cfg.action_dim
    frames = []
    for t in range(golden.shape[0]):
        action = np.asarray(jnp.sin(jnp.arange(B * A, dtype=jnp.float32).reshape(B, A) * 0.7 + t * 0.3))
        state, _ = env.step(state, torch.as_tensor(action))
        frames.append(np.concatenate([state.scene.bodies.pos.numpy().reshape(B, -1),
                                      state.scene.particles.pos.numpy().reshape(B, -1)], axis=-1))
    np.testing.assert_allclose(np.stack(frames), golden, atol=5e-3, rtol=1e-3)
