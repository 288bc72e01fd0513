"""Batched XPBD solver for rigid bodies (port of `geometry_rl_tpu/sim/xpbd.py`).

Per substep (Müller et al., "Detailed Rigid Body Simulation with XPBD",
2020): integrate velocities (gravity, damping, axis locks) and poses; run
`iterations` passes of fixed joints (orientation weld, then the positional
anchor), point-vs-SDF contacts with static friction and two-body contacts;
recover velocities from the pose change. `step_physics` runs `decimation`
substeps under one control action.

The constraint descriptions of the particle path are here too; the cloth env
solves its particles through the fused kernel in `sim/cloth_solve.py`. Not
ported yet, and refused with `NotImplementedError`: the particle branch of
`xpbd_substep` (distance groups, self contacts, attachments, particle-SDF
contact; ROADMAP.md Queue 1 item 8) and the velocity pass that restitution
or dynamic friction turns on (item 12).

Every function is a chain of tensor operations with no host
synchronisation, so a rollout on the card stays asynchronous. Body indices
of contacts are Python ints; joint indices are device tensors, and their
corrections are summed onto the bodies with `index_add_`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.math import quat_apply, quat_conjugate, quat_mul, quat_normalize
from .types import FixedJointSpec, RigidBodySpec, RigidBodyState, SceneState

GRAVITY_MAG = 9.81
GRAVITY = (0.0, 0.0, -GRAVITY_MAG)

SDFFn = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]
"""world points [..., 3] -> (signed distance [...], unit normal [..., 3])."""


# ---------------------------------------------------------------------------
# constraint descriptions
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ContactSet:
    """Collision points of one body against one SDF. `local_points` is [P, 3]
    or [B, P, 3] in the body frame; `sdf` receives world points [B, P, 3]
    and may close over per-env tensors."""

    body: int
    local_points: torch.Tensor
    sdf: SDFFn
    friction: float = 0.5
    restitution: float = 0.0  # > 0 needs the velocity pass (not ported)
    dynamic_friction: float = 0.0  # > 0 needs the velocity pass (not ported)


@dataclasses.dataclass(frozen=True, eq=False)
class BodyPairContact:
    """Two-body contact: sample points of `body_points` against the
    local-frame SDF of `body_sdf` (the pushing stick against the peg prism);
    impulses act on both bodies."""

    body_points: int
    body_sdf: int
    local_points: torch.Tensor  # [P, 3] or [B, P, 3]
    sdf: SDFFn  # local frame of body_sdf
    friction: float = 0.5
    restitution: float = 0.0
    dynamic_friction: float = 0.0


class DistanceGroup(NamedTuple):
    """One conflict-free group of particle distance constraints: within a
    group no particle appears twice, so all its constraints solve in parallel.
    `mask` disables constraints per env (cloth hole cutouts)."""

    i: torch.Tensor  # [C] int32 particle indices
    j: torch.Tensor  # [C]
    rest: torch.Tensor  # [C] rest lengths
    compliance: torch.Tensor  # [C] XPBD compliance (0 = rigid)
    mask: Optional[torch.Tensor] = None  # [B, C]; 1 = active


class ParticleSpec(NamedTuple):
    inv_mass: torch.Tensor  # [NP] or [B, NP]
    lin_damping: float = 0.0


class ParticleSelfContact(NamedTuple):
    """All-pairs particle self-collision: any non-excluded pair is pushed
    apart to `min_dist`. `pair_mask` [NP, NP] excludes self and constrained
    neighbours; `active` [B, NP] gates particles (hole cutouts)."""

    min_dist: float
    pair_mask: torch.Tensor
    active: Optional[torch.Tensor] = None


class BodyAttachment(NamedTuple):
    """Pin particles to body-local points (cloth corner <-> gripper cube)."""

    particle: torch.Tensor  # [A] int32
    body: torch.Tensor  # [A] int32
    local_pos: torch.Tensor  # [A, 3]


# ---------------------------------------------------------------------------
# rigid-body helpers
# ---------------------------------------------------------------------------


def _inv_inertia_world(quat: torch.Tensor, inv_inertia_body: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """World-frame inverse inertia applied to u: R I_b^-1 R^T u."""
    u_body = quat_apply(quat_conjugate(quat), u)
    return quat_apply(quat, inv_inertia_body * u_body)


def _skew(u: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(u[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -u[..., 2], u[..., 1]], dim=-1),
            torch.stack([u[..., 2], zero, -u[..., 0]], dim=-1),
            torch.stack([-u[..., 1], u[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def _gyroscopic_step(quat: torch.Tensor, w: torch.Tensor, inv_inertia: torch.Tensor, dt: float) -> torch.Tensor:
    """Implicit gyroscopic update of world angular velocity w: one Newton
    step on I (w1 - w0) + dt w1 x (I w1) = 0 in the body frame. Bodies with
    a zero inverse inertia on any axis pass through unchanged."""
    wb = quat_apply(quat_conjugate(quat), w)
    valid = (inv_inertia > 0.0).all(dim=-1)
    ib = torch.where(inv_inertia > 0.0, 1.0 / torch.clamp(inv_inertia, min=1e-12), 0.0)
    iw = ib * wb
    f = dt * torch.linalg.cross(wb, iw, dim=-1)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    J = ib[..., None] * eye + dt * (_skew(wb) @ (ib[..., :, None] * eye) - _skew(iw))
    dwb = torch.linalg.solve_ex(J, f[..., None])[0][..., 0]  # singular J (static bodies) masked below
    wb1 = torch.where(valid[..., None], wb - dwb, wb)
    return quat_apply(quat, wb1)


def _generalized_inv_mass(quat, inv_mass, inv_inertia, r, n) -> torch.Tensor:
    """w = 1/m + (r x n)^T I^-1 (r x n) for a positional impulse at offset r."""
    rxn = torch.linalg.cross(r, n, dim=-1)
    return inv_mass + (rxn * _inv_inertia_world(quat, inv_inertia, rxn)).sum(dim=-1)


def _rotate_by(quat: torch.Tensor, dw: torch.Tensor) -> torch.Tensor:
    """quat advanced by the small world rotation vector dw, renormalised."""
    dq = 0.5 * quat_mul(torch.cat([torch.zeros_like(dw[..., :1]), dw], dim=-1), quat)
    return quat_normalize(quat + dq)


def _apply_impulse(pos, quat, inv_mass, inv_inertia, free_pos, free_rot, r, p):
    """Positional impulse p at world offset r -> (new_pos, new_quat)."""
    dpos = p * inv_mass[..., None] * free_pos
    dw = _inv_inertia_world(quat, inv_inertia, torch.linalg.cross(r, p, dim=-1)) * free_rot
    return pos + dpos, _rotate_by(quat, dw)


def with_bodies(x: torch.Tensor, updates) -> torch.Tensor:
    """x [B, NB, D] with the bodies of `updates` ({body: [B, D]}) replaced,
    out of place (the reference's `.at[:, b].set`)."""
    parts, start = [], 0
    for b in sorted(updates):
        parts += [x[:, start:b], updates[b][:, None]]
        start = b + 1
    parts.append(x[:, start:])
    return torch.cat(parts, dim=1)


# ---------------------------------------------------------------------------
# constraint solves (one Jacobi pass each)
# ---------------------------------------------------------------------------


def _solve_fixed_joints(pos, quat, spec: RigidBodySpec, joints: FixedJointSpec, relax: float = 1.0):
    """One pass over fixed joints: orientation weld, then the positional
    anchor from the welded orientations. Each joint's correction is computed
    as if it acted alone and summed onto its bodies, scaled by 1/K for a body
    shared by K joints (Jacobi averaging: the two-agent scenes weld two
    grippers to one object and diverge without it; K = 1 elsewhere)."""
    B, NB = pos.shape[:2]
    ia, ib = joints.body_a, joints.body_b  # [NJ]
    im_a, ii_a = spec.inv_mass[ia], spec.inv_inertia[ia]
    im_b, ii_b = spec.inv_mass[ib], spec.inv_inertia[ib]

    ones = torch.ones(ia.shape, dtype=pos.dtype, device=pos.device)
    joint_count = torch.zeros(NB, dtype=pos.dtype, device=pos.device).index_add_(0, ia, ones).index_add_(0, ib, ones)
    inv_count = 1.0 / torch.clamp(joint_count, min=1.0)
    inv_count_a, inv_count_b = inv_count[ia][None, :, None], inv_count[ib][None, :, None]

    def scatter(vals_a, vals_b):
        out = torch.zeros((B, NB, vals_a.shape[-1]), dtype=vals_a.dtype, device=vals_a.device)
        return out.index_add_(1, ia, vals_a * inv_count_a).index_add_(1, ib, vals_b * inv_count_b)

    # --- stage 1: orientation weld (drive q_b -> q_a * rel_quat) ----------
    qa, qb = quat[:, ia], quat[:, ib]
    rel = joints.rel_quat if joints.rel_quat.ndim == 3 else joints.rel_quat[None]
    dq = quat_mul(quat_mul(qa, rel), quat_conjugate(qb))
    sign = torch.sign(dq[..., :1] + 1e-12)
    theta = 2.0 * dq[..., 1:] * sign  # small-angle rotation vector
    # split by angular weights (scalar approximation with diagonal inertias)
    wa_r = ii_a.sum(dim=-1) / 3.0
    wb_r = ii_b.sum(dim=-1) / 3.0
    denom_r = torch.clamp(wa_r + wb_r, min=1e-12)
    dth_a = -theta * (wa_r / denom_r)[..., None] * relax * spec.free_rot[ia]
    dth_b = theta * (wb_r / denom_r)[..., None] * relax * spec.free_rot[ib]
    quat = _rotate_by(quat, scatter(dth_a, dth_b))

    # --- stage 2: positional anchor (from the welded orientations) --------
    pa, qa = pos[:, ia], quat[:, ia]
    pb, qb = pos[:, ib], quat[:, ib]
    lpa = joints.local_pos_a if joints.local_pos_a.ndim == 3 else joints.local_pos_a[None]
    lpb = joints.local_pos_b if joints.local_pos_b.ndim == 3 else joints.local_pos_b[None]
    ra = quat_apply(qa, lpa)
    rb = quat_apply(qb, lpb)
    c = (pa + ra) - (pb + rb)  # [B, NJ, 3] violation
    c_norm = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    n = c / torch.clamp(c_norm, min=1e-9)
    wa = _generalized_inv_mass(qa, im_a, ii_a, ra, n)
    wb = _generalized_inv_mass(qb, im_b, ii_b, rb, n)
    lam = -c_norm.squeeze(-1) / torch.clamp(wa + wb, min=1e-12)
    p = lam[..., None] * n * relax

    dpos = scatter(p * im_a[..., None] * spec.free_pos[ia], -p * im_b[..., None] * spec.free_pos[ib])
    dw_a = _inv_inertia_world(qa, ii_a, torch.linalg.cross(ra, p, dim=-1)) * spec.free_rot[ia]
    dw_b = -_inv_inertia_world(qb, ii_b, torch.linalg.cross(rb, p, dim=-1)) * spec.free_rot[ib]
    return pos + dpos, _rotate_by(quat, scatter(dw_a, dw_b))


def _local_points(contact, B: int) -> torch.Tensor:
    lp = contact.local_points
    return lp.expand((B,) + lp.shape) if lp.ndim == 2 else lp


def _solve_body_contacts(pos, quat, prev_pos, prev_quat, spec: RigidBodySpec, contact: ContactSet, mu_scale=1.0):
    """One pass of point-vs-SDF contact for one body, with static friction
    against the substep's tangential motion of each point. The normal and
    friction impulses of all points are summed into one body update. Also
    returns the per-point normal lambda [B, P]."""
    b = contact.body
    lp = _local_points(contact, pos.shape[0])

    p_b, q_b = pos[:, b], quat[:, b]
    r = quat_apply(q_b[:, None, :], lp)  # [B, P, 3] world offsets
    world_pts = p_b[:, None, :] + r

    phi, n = contact.sdf(world_pts)  # [B, P], [B, P, 3]
    pen = torch.clamp(phi, max=0.0)  # negative inside
    active = (phi < 0.0).to(pos.dtype)

    im, ii = spec.inv_mass[b], spec.inv_inertia[b]
    w = _generalized_inv_mass(q_b[:, None, :], im, ii, r, n)  # [B, P]
    lam_n = -pen / torch.clamp(w, min=1e-12) * active  # >= 0
    p_imp = lam_n[..., None] * n

    # friction: oppose the contact point's tangential displacement this substep
    prev_pts = prev_pos[:, b][:, None, :] + quat_apply(prev_quat[:, b][:, None, :], lp)
    disp = world_pts - prev_pts
    disp_t = disp - (disp * n).sum(dim=-1, keepdim=True) * n
    t_norm = torch.linalg.vector_norm(disp_t, dim=-1, keepdim=True)
    t_dir = disp_t / torch.clamp(t_norm, min=1e-9)
    w_t = _generalized_inv_mass(q_b[:, None, :], im, ii, r, t_dir)
    lam_t = torch.minimum(t_norm.squeeze(-1) / torch.clamp(w_t, min=1e-12), contact.friction * mu_scale * lam_n)
    p_imp = p_imp - (lam_t * active)[..., None] * t_dir

    total_p = p_imp.sum(dim=1)
    total_ang = torch.linalg.cross(r, p_imp, dim=-1).sum(dim=1)
    new_p = p_b + total_p * im * spec.free_pos[b]
    new_q = _rotate_by(q_b, _inv_inertia_world(q_b, ii, total_ang) * spec.free_rot[b])
    return with_bodies(pos, {b: new_p}), with_bodies(quat, {b: new_q}), lam_n


def _solve_body_pair_contact(pos, quat, spec: RigidBodySpec, contact: BodyPairContact):
    """One pass of two-body point-vs-SDF contact (normal only; tangential
    motion is left to the velocity recovery). Returns the lambda [B, P] too."""
    bi, bj = contact.body_points, contact.body_sdf
    lp = _local_points(contact, pos.shape[0])

    p_i, q_i = pos[:, bi], quat[:, bi]
    p_j, q_j = pos[:, bj], quat[:, bj]
    r_i = quat_apply(q_i[:, None, :], lp)  # [B, P, 3]
    world_pts = p_i[:, None, :] + r_i

    # into body_j's local frame
    local_j = quat_apply(quat_conjugate(q_j)[:, None, :], world_pts - p_j[:, None, :])
    phi, n_local = contact.sdf(local_j)
    n = quat_apply(q_j[:, None, :], n_local)  # world-frame normal
    pen = torch.clamp(phi, max=0.0)
    active = (phi < 0.0).to(pos.dtype)

    r_j = world_pts - p_j[:, None, :]
    im_i, ii_i = spec.inv_mass[bi], spec.inv_inertia[bi]
    im_j, ii_j = spec.inv_mass[bj], spec.inv_inertia[bj]
    w_i = _generalized_inv_mass(q_i[:, None, :], im_i, ii_i, r_i, n)
    w_j = _generalized_inv_mass(q_j[:, None, :], im_j, ii_j, r_j, n)
    lam = -pen / torch.clamp(w_i + w_j, min=1e-12) * active
    p_imp = lam[..., None] * n  # pushes body_i out along +n

    new_pi = p_i + p_imp.sum(dim=1) * im_i * spec.free_pos[bi]
    dwi = _inv_inertia_world(q_i, ii_i, torch.linalg.cross(r_i, p_imp, dim=-1).sum(dim=1)) * spec.free_rot[bi]
    new_pj = p_j + (-p_imp).sum(dim=1) * im_j * spec.free_pos[bj]
    dwj = _inv_inertia_world(q_j, ii_j, torch.linalg.cross(r_j, -p_imp, dim=-1).sum(dim=1)) * spec.free_rot[bj]
    pos = with_bodies(pos, {bi: new_pi, bj: new_pj})
    quat = with_bodies(quat, {bi: _rotate_by(q_i, dwi), bj: _rotate_by(q_j, dwj)})
    return pos, quat, lam


# ---------------------------------------------------------------------------
# the substep
# ---------------------------------------------------------------------------


def xpbd_substep(
    state: SceneState,
    body_spec: RigidBodySpec,
    dt: float,
    *,
    joints: Optional[FixedJointSpec] = None,
    contacts: Sequence[ContactSet] = (),
    pair_contacts: Sequence[BodyPairContact] = (),
    particle_spec: Optional[ParticleSpec] = None,
    distance_groups: Sequence[DistanceGroup] = (),
    attachments: Optional[BodyAttachment] = None,
    particle_contacts: Sequence = (),
    self_contacts: Sequence[ParticleSelfContact] = (),
    iterations: int = 8,
    max_velocity: float = 1e3,
    gyroscopic: bool = False,
) -> SceneState:
    """One physics substep of the bodies (dt = sim.dt, run `decimation`
    times per control step)."""
    if particle_spec is not None or state.particles is not None or distance_groups or attachments is not None \
            or particle_contacts or self_contacts:
        raise NotImplementedError(
            "the particle branch of xpbd_substep (distance groups, self contacts, attachments, particle-SDF "
            "contact) is not ported yet: ROADMAP.md Queue 1 item 8"
        )
    if any(c.restitution > 0.0 or c.dynamic_friction > 0.0 for c in (*contacts, *pair_contacts)):
        raise NotImplementedError(
            "the XPBD velocity pass (restitution / dynamic friction) is not ported yet: ROADMAP.md Queue 1 item 12"
        )
    bodies = state.bodies

    # 1. integrate -----------------------------------------------------------
    gravity = torch.zeros(3, dtype=bodies.lin_vel.dtype, device=bodies.lin_vel.device)
    gravity[2].fill_(-GRAVITY_MAG)  # a fill kernel; `gravity[2] = x` would copy x from the host and synchronise
    lin_damp = torch.exp(-body_spec.lin_damping * dt)
    ang_damp = torch.exp(-body_spec.ang_damping * dt)
    v = (bodies.lin_vel + dt * gravity * body_spec.gravity_scale[:, None]) * lin_damp[:, None]
    w = bodies.ang_vel * ang_damp[:, None]
    v = torch.clamp(v * body_spec.free_pos, -max_velocity, max_velocity)
    if gyroscopic:
        w = _gyroscopic_step(bodies.quat, w, body_spec.inv_inertia, dt)
    w = w * body_spec.free_rot

    prev_pos, prev_quat = bodies.pos, bodies.quat
    pos = bodies.pos + dt * v
    w_quat = torch.cat([torch.zeros_like(w[..., :1]), w], dim=-1)
    quat = quat_normalize(bodies.quat + 0.5 * dt * quat_mul(w_quat, bodies.quat))

    # 2. position solve --------------------------------------------------------
    for _ in range(iterations):
        if joints is not None:
            pos, quat = _solve_fixed_joints(pos, quat, body_spec, joints)
        for contact in contacts:
            pos, quat, _ = _solve_body_contacts(pos, quat, prev_pos, prev_quat, body_spec, contact)
        for contact in pair_contacts:
            pos, quat, _ = _solve_body_pair_contact(pos, quat, body_spec, contact)

    # 3. velocity recovery -----------------------------------------------------
    new_v = (pos - prev_pos) / dt * body_spec.free_pos
    dq_vel = quat_mul(quat, quat_conjugate(prev_quat))
    sign = torch.sign(dq_vel[..., :1] + 1e-12)
    new_w = 2.0 * dq_vel[..., 1:] * sign / dt * body_spec.free_rot
    return SceneState(bodies=RigidBodyState(pos=pos, quat=quat, lin_vel=new_v, ang_vel=new_w), particles=None)


def step_physics(state: SceneState, body_spec: RigidBodySpec, dt: float, decimation: int, **kwargs) -> SceneState:
    """`decimation` substeps under one control action."""
    for _ in range(decimation):
        state = xpbd_substep(state, body_spec, dt, **kwargs)
    return state
