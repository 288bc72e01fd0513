"""Batched XPBD solver for rigid bodies and particles (port of
`geometry_rl_tpu/sim/xpbd.py`).

Per substep (Müller et al., "Detailed Rigid Body Simulation with XPBD",
2020): integrate velocities (gravity, damping, axis locks) and poses; run
`iterations` passes of fixed joints (orientation weld, then the positional
anchor), point-vs-SDF contacts with static friction, two-body contacts and,
per particle system, the distance groups in sequence, self contacts,
particle<->body attachments and particle-vs-SDF contacts; recover velocities
from the pose change; then, only for contacts with a restitution or a
dynamic friction above zero, the velocity pass (§3.6 of the paper).
`step_physics` runs `decimation` substeps under one control action.

The rope tasks and the cloth env's `use_pallas_solver=False` mode solve
their particles here; the cloth env's other modes go through the fused
kernel in `sim/cloth_solve.py`.

Every function is a chain of tensor operations with no host
synchronisation, so a rollout on the card stays asynchronous. Body indices
of contacts are Python ints; joint, constraint and attachment indices are
device tensors. A conflict-free distance group writes each particle once
with `index_add`; the joints' and attachments' corrections, where a body
may take several, are summed in a fixed order made once with the scene
(`sum_order`, `ordered_sum`), so a run gives the same bits every time.
Restitution, dynamic friction and the particles' damping are Python floats:
a zero skips its branch before any tensor is made.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.math import quat_apply, quat_conjugate, quat_mul, quat_normalize
from ..utils.trace import span, spanned
from .types import FixedJointSpec, ParticleState, RigidBodySpec, RigidBodyState, SceneState

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
    # velocity-pass parameters; both at 0 run no pass
    restitution: float = 0.0
    dynamic_friction: float = 0.0


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


@dataclasses.dataclass(frozen=True, eq=False)
class ParticleSDFContact:
    """All particles against one SDF (cloth vs hook, rope vs ground and pole)."""

    sdf: SDFFn
    friction: float = 0.3
    restitution: float = 0.0
    dynamic_friction: float = 0.0


def _needs_velocity_pass(contact) -> bool:
    return contact.restitution > 0.0 or contact.dynamic_friction > 0.0


class DistanceGroup(NamedTuple):
    """One conflict-free group of particle distance constraints: within a
    group no particle appears twice, so all its constraints solve in parallel.
    `mask` disables constraints per env (cloth hole cutouts)."""

    i: torch.Tensor  # [C] int particle indices
    j: torch.Tensor  # [C]
    rest: torch.Tensor  # [C] or [B, C] rest lengths
    compliance: torch.Tensor  # [C] XPBD compliance (0 = rigid)
    mask: Optional[torch.Tensor] = None  # [C] or [B, C]; 1 = active


class ParticleSpec(NamedTuple):
    inv_mass: torch.Tensor  # [NP] or [B, NP]
    lin_damping: float = 0.0


class ParticleSelfContact(NamedTuple):
    """All-pairs particle self-collision: any non-excluded pair is pushed
    apart to `min_dist`. `pair_mask` [NP, NP] excludes self and constrained
    neighbours; `active` [NP] or [B, NP] gates particles (hole cutouts)."""

    min_dist: float
    pair_mask: torch.Tensor
    active: Optional[torch.Tensor] = None


class BodyAttachment(NamedTuple):
    """Pin particles to body-local points (cloth corner <-> gripper cube).
    `particle_order` / `body_order` are the fixed orders of the sums into
    particles and bodies (`attachment_sum_order`; made on the spot if None)."""

    particle: torch.Tensor  # [A] int
    body: torch.Tensor  # [A] int
    local_pos: torch.Tensor  # [A, 3] or [B, A, 3]
    particle_order: Optional[torch.Tensor] = None  # [NP, D] `sum_order(particle, NP)`
    body_order: Optional[torch.Tensor] = None  # [NB, D] `sum_order(body, NB)`


# ---------------------------------------------------------------------------
# fixed-order sums by a static index
# ---------------------------------------------------------------------------


def sum_order(index: torch.Tensor, n: int) -> torch.Tensor:
    """The fixed order of a sum of K rows by a static index [K] into n
    targets: [n, D] row numbers, each target's rows in increasing order, its
    other slots K (the zero row after the rows, `with_zero_row`). D is the
    most rows one target takes, at least 1. Reads the index on the host: it
    is made once, with the scene."""
    idx = index.tolist()
    rows = [[k for k, i in enumerate(idx) if i == t] for t in range(n)]
    depth = max([1] + [len(r) for r in rows])
    return torch.tensor([r + [len(idx)] * (depth - len(r)) for r in rows], dtype=torch.int64, device=index.device)


def with_zero_row(*parts: torch.Tensor) -> torch.Tensor:
    """The [B, K_i, F] rows of `parts` and a zero row after them: [B, sum K_i + 1, F]."""
    p = parts[0]
    return torch.cat([*parts, p.new_zeros((p.shape[0], 1, p.shape[2]))], dim=1)


def ordered_sum(rows: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """rows [B, K + 1, F] (the last a zero row) summed per target in
    `order` [n, D] (`sum_order`): [B, n, F], each target's rows added one
    after the other, the same bits on every run and device."""
    n, depth = order.shape
    g = rows.index_select(1, order.reshape(-1)).reshape(rows.shape[0], n, depth, rows.shape[2])
    out = g[:, :, 0]
    for d in range(1, depth):
        out = out + g[:, :, d]
    return out


def joint_sum_order(joints: FixedJointSpec, num_bodies: int) -> FixedJointSpec:
    """`joints` with its static sums made: the order of the sum into each
    body over the rows [a-side corrections; b-side corrections], and each
    row's 1/K, K the number of joints at its body (Jacobi averaging), with a
    1 for the zero row."""
    both = torch.cat([joints.body_a, joints.body_b])
    order = sum_order(both, num_bodies)
    count = (order < len(both)).sum(dim=1).to(joints.local_pos_a.dtype)
    inv_count = 1.0 / torch.clamp(count, min=1.0)
    return joints._replace(sum_order=order, inv_count=torch.cat([inv_count[both], inv_count.new_ones(1)]))


def attachment_sum_order(att: BodyAttachment, num_particles: int, num_bodies: int) -> BodyAttachment:
    """`att` with the orders of its sums into particles and bodies made."""
    return att._replace(particle_order=sum_order(att.particle, num_particles), body_order=sum_order(att.body, num_bodies))


def _no_order_on_card(spec, x: torch.Tensor, maker: str) -> None:
    """A spec without its sum order gets one made in the solver, from its
    index read on the host: for CPU tensors only (specs made by hand). On the
    card that read would stall every substep, so a scene makes the order
    once with `maker` and a spec without it raises."""
    if x.device.type != "cpu":
        raise ValueError(f"{type(spec).__name__} on {x.device} has no sum order: make it once with the scene ({maker})")


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
    grippers to one object and diverge without it; K = 1 elsewhere). The
    sums into bodies follow `joints.sum_order` (`joint_sum_order`)."""
    if joints.sum_order is None:
        _no_order_on_card(joints, pos, "joint_sum_order")
        joints = joint_sum_order(joints, pos.shape[1])
    ia, ib = joints.body_a, joints.body_b  # [NJ]
    im_a, ii_a = spec.inv_mass[ia], spec.inv_inertia[ia]
    im_b, ii_b = spec.inv_mass[ib], spec.inv_inertia[ib]
    weights = joints.inv_count[None, :, None]

    def scatter(vals_a, vals_b):
        return ordered_sum(with_zero_row(vals_a, vals_b) * weights, joints.sum_order)

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


def _solve_distance_group(x, inv_mass, group: DistanceGroup, dt):
    """Parallel distance-constraint solve for one conflict-free group. No
    particle index repeats inside a group, so the two `index_add`s write
    each row at most once and the result does not depend on their order."""
    gi, gj = group.i, group.j
    xi, xj = x[:, gi], x[:, gj]  # [B, C, 3]
    wi = inv_mass[..., gi] if inv_mass.ndim == 2 else inv_mass[gi][None]
    wj = inv_mass[..., gj] if inv_mass.ndim == 2 else inv_mass[gj][None]
    rest = group.rest if group.rest.ndim == 2 else group.rest[None]

    d = xi - xj
    dist = torch.linalg.vector_norm(d, dim=-1)
    n = d / torch.clamp(dist, min=1e-9)[..., None]
    alpha = group.compliance[None] / (dt * dt)
    lam = -(dist - rest) / torch.clamp(wi + wj + alpha, min=1e-12)
    if group.mask is not None:
        lam = lam * (group.mask if group.mask.ndim == 2 else group.mask[None])
    dx = lam[..., None] * n
    x = x.index_add(1, gi, dx * wi[..., None])
    return x.index_add(1, gj, dx * wj[..., None], alpha=-1.0)


def _solve_self_contacts(x, inv_mass, sc: ParticleSelfContact):
    """One Jacobi pass of all-pairs particle separation: each violating pair
    is pushed apart along its axis, split by inverse masses, and a particle's
    corrections are averaged over its violating pairs. The [B, N, N, 3]
    difference is the only temporary of that size kept alive."""
    d = x[:, :, None, :] - x[:, None, :, :]  # [B, N, N, 3]
    dist = torch.linalg.vector_norm(d + 1e-12, dim=-1)  # the reference's eps at i == j
    w = inv_mass if inv_mass.ndim == 2 else inv_mass[None]  # [B?, N]
    viol = torch.clamp(sc.min_dist - dist, min=0.0) * sc.pair_mask
    if sc.active is not None:
        a = sc.active if sc.active.ndim == 2 else sc.active[None]
        viol = viol * a[:, :, None] * a[:, None, :]
    # i gets +viol * w_i / (w_i + w_j) along n; j gets the mirror from its row
    corr = viol / torch.clamp(w[:, :, None] + w[:, None, :], min=1e-12) * w[:, :, None]  # [B, N, N]
    counts = torch.clamp((viol > 0).sum(dim=-1), min=1)  # [B, N]
    scale = corr / torch.clamp(dist, min=1e-9)  # corr * n == scale * d
    dx = (scale[:, :, None, :] @ d).squeeze(2) / counts[..., None]
    return x + dx


def _solve_attachments(x, inv_mass, pos, quat, spec: RigidBodySpec, att: BodyAttachment):
    """Particle <-> body pins, two-way: the particle and the body both move,
    by their generalised inverse masses. The corrections are summed per
    particle and per body in the attachments' fixed orders, so a body that
    holds several attachments gets them all."""
    if att.particle_order is None or att.body_order is None:
        _no_order_on_card(att, x, "attachment_sum_order")
        att = attachment_sum_order(att, x.shape[1], pos.shape[1])
    ap, ab = att.particle, att.body
    lp = att.local_pos if att.local_pos.ndim == 3 else att.local_pos[None]
    qb, pb = quat[:, ab], pos[:, ab]
    r = quat_apply(qb, lp)
    target = pb + r

    xp = x[:, ap]
    wp = inv_mass[..., ap] if inv_mass.ndim == 2 else inv_mass[ap][None]
    im_b, ii_b = spec.inv_mass[ab], spec.inv_inertia[ab]

    c = xp - target
    c_norm = torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    n = c / torch.clamp(c_norm, min=1e-9)
    wb = _generalized_inv_mass(qb, im_b, ii_b, r, n)
    lam = -c_norm.squeeze(-1) / torch.clamp(wp + wb, min=1e-12)
    dx = lam[..., None] * n
    x = x + ordered_sum(with_zero_row(dx * wp[..., None]), att.particle_order)

    p_imp = -dx
    dpos_j = p_imp * im_b[..., None] * spec.free_pos[ab]
    dw_j = _inv_inertia_world(qb, ii_b, torch.linalg.cross(r, p_imp, dim=-1)) * spec.free_rot[ab]
    d = ordered_sum(with_zero_row(torch.cat([dpos_j, dw_j], dim=-1)), att.body_order)  # [B, NB, 6]
    return x, pos + d[..., :3], _rotate_by(quat, d[..., 3:])


def _solve_particle_contact(x, prev_x, pc: ParticleSDFContact):
    """One pass of all particles against one SDF, with static friction that
    removes tangential motion at the contacts. Also returns the normal
    correction -pen [B, NP] (the velocity pass's per-particle load)."""
    phi, n = pc.sdf(x)
    pen = torch.clamp(phi, max=0.0)
    depth = -pen[..., None]
    dx_n = depth * n
    disp = x - prev_x
    disp_t = disp - (disp * n).sum(dim=-1, keepdim=True) * n
    t_norm = torch.linalg.vector_norm(disp_t, dim=-1, keepdim=True)
    scale = torch.clamp(pc.friction * depth / torch.clamp(t_norm, min=1e-9), max=1.0)
    active = (phi < 0.0).to(x.dtype)[..., None]
    return x + active * (dx_n - scale * disp_t), -pen


# ---------------------------------------------------------------------------
# velocity pass (restitution and dynamic friction, §3.6 of the paper)
# ---------------------------------------------------------------------------


def _conormal_manifolds(active, n, lam_n, vecs):
    """Soft-cluster the active contact points into co-normal manifolds:
    points p, q share one iff both are active and n_p . n_q > 0.9. Returns
    per point the group size cnt_safe [B, P] (>= 1), the normalised summed
    group normal n_bar [B, P, 3], the summed group lambda lam_tot [B, P] and
    the group mean of every [B, P, 3] tensor of `vecs`. Every member of a
    group computes the same aggregates, so a group impulse divided by cnt and
    summed over the members applies exactly once; opposing patches (a peg
    astride both walls of a hole) stay apart. The adjacency is [B, P, P]: 37
    MB in f32 at 1000 envs with the rigid tasks' 96 surface points a body."""
    pair = active[:, :, None] * active[:, None, :]  # [B, P, P]
    A = ((n @ n.transpose(1, 2)) > 0.9).to(n.dtype) * pair
    cnt_safe = torch.clamp(A.sum(dim=-1), min=1.0)  # [B, P]
    n_sum = A @ n
    n_bar = n_sum / torch.clamp(torch.linalg.vector_norm(n_sum, dim=-1, keepdim=True), min=1e-9)
    lam_tot = (A @ lam_n[..., None]).squeeze(-1)
    means = tuple((A @ v) / cnt_safe[..., None] for v in vecs)
    return cnt_safe, n_bar, lam_tot, means


def _manifold_impulse(v_pt, v_pt_pre, n_bar, w_of, lam_tot, gate, dt, restitution, dynamic_friction):
    """Restitution and Coulomb-budget dynamic friction impulse of a manifold.
    v_pt / v_pt_pre [B, P, 3]: (relative) contact-point velocity after and
    before the position solve; w_of(dir) -> generalised inverse mass along
    dir [B, P]; lam_tot: summed normal lambda (the friction budget); gate
    zeroes inactive points. restitution and dynamic_friction are Python
    floats, and a zero leaves its branch out."""
    vn = (v_pt * n_bar).sum(dim=-1)
    p = torch.zeros_like(v_pt)
    if restitution > 0.0:
        # dv_n = -vn + max(-e * vn_pre, 0). The stopping term -vn removes the
        # separation velocity the push-out injected, at most lam_tot / dt, so
        # a contact that is really separating is not pulled back
        vn_pre = (v_pt_pre * n_bar).sum(dim=-1)
        e = torch.where(torch.abs(vn_pre) > 2.0 * GRAVITY_MAG * dt, restitution, 0.0)
        dv_n = (-torch.minimum(vn, lam_tot / dt) + torch.clamp(-e * vn_pre, min=0.0)) * gate
        p = p + (dv_n / torch.clamp(w_of(n_bar), min=1e-12))[..., None] * n_bar
    if dynamic_friction > 0.0:
        vt = v_pt - vn[..., None] * n_bar
        vt_norm = torch.linalg.vector_norm(vt, dim=-1)
        t_dir = vt / torch.clamp(vt_norm, min=1e-9)[..., None]
        p_stop = vt_norm / torch.clamp(w_of(t_dir), min=1e-12)
        # Coulomb budget: mu * the manifold's total normal impulse
        p_fric = torch.minimum(p_stop, dynamic_friction * lam_tot / dt) * gate
        p = p - p_fric[..., None] * t_dir
    return p


def _velocity_pass_body_contact(lin_vel, ang_vel, pos, quat, pred_pos, pred_quat, v_pre, w_pre, spec: RigidBodySpec,
                                contact: ContactSet, lam_n, dt):
    """Restitution and dynamic Coulomb friction for one body-vs-SDF contact
    set. lam_n [B, P] is the normal lambda summed over the position
    iterations (the load each point really carried); v_pre / w_pre are the
    velocities after integration, the approach velocity for restitution."""
    b = contact.body
    lp = _local_points(contact, pos.shape[0])
    q_b, p_b = quat[:, b], pos[:, b]
    r = quat_apply(q_b[:, None, :], lp)  # [B, P, 3] offsets at the final pose
    phi, n = contact.sdf(p_b[:, None, :] + r)
    # in contact: loaded by the position solve and still touching at the end
    active = ((lam_n > 0.0) & (phi < 1e-3)).to(pos.dtype)  # [B, P]

    pred_r = quat_apply(pred_quat[:, b][:, None, :], lp)
    cnt_safe, n_bar, lam_tot, (r_bar, pred_r_bar) = _conormal_manifolds(active, n, lam_n, (r, pred_r))

    im, ii = spec.inv_mass[b], spec.inv_inertia[b]

    def w_of(d):
        return _generalized_inv_mass(q_b[:, None, :], im, ii, r_bar, d)  # [B, P]

    v_pt = lin_vel[:, b][:, None, :] + torch.linalg.cross(ang_vel[:, b][:, None, :], r_bar, dim=-1)
    v_pt_pre = v_pre[:, b][:, None, :] + torch.linalg.cross(w_pre[:, b][:, None, :], pred_r_bar, dim=-1)
    p = _manifold_impulse(v_pt, v_pt_pre, n_bar, w_of, lam_tot, active, dt, contact.restitution,
                          contact.dynamic_friction) / cnt_safe[..., None]  # [B, P, 3]

    dv = p.sum(dim=1) * im * spec.free_pos[b]
    dw = _inv_inertia_world(q_b, ii, torch.linalg.cross(r_bar, p, dim=-1).sum(dim=1)) * spec.free_rot[b]
    return with_bodies(lin_vel, {b: lin_vel[:, b] + dv}), with_bodies(ang_vel, {b: ang_vel[:, b] + dw})


def _velocity_pass_body_pair_contact(lin_vel, ang_vel, pos, quat, pred_pos, pred_quat, v_pre, w_pre,
                                     spec: RigidBodySpec, contact: BodyPairContact, lam_n, dt):
    """Restitution and dynamic Coulomb friction for a two-body contact: equal
    and opposite impulses on both bodies from the relative contact-point
    velocity, with the lambda budget of the body-vs-SDF pass."""
    bi, bj = contact.body_points, contact.body_sdf
    lp = _local_points(contact, pos.shape[0])

    q_i, p_i = quat[:, bi], pos[:, bi]
    q_j, p_j = quat[:, bj], pos[:, bj]
    r_i = quat_apply(q_i[:, None, :], lp)  # [B, P, 3]
    world_pts = p_i[:, None, :] + r_i
    local_j = quat_apply(quat_conjugate(q_j)[:, None, :], world_pts - p_j[:, None, :])
    phi, n_local = contact.sdf(local_j)
    n = quat_apply(q_j[:, None, :], n_local)
    r_j = world_pts - p_j[:, None, :]

    active = ((lam_n > 0.0) & (phi < 1e-3)).to(pos.dtype)  # [B, P]

    pred_r_i = quat_apply(pred_quat[:, bi][:, None, :], lp)
    pred_r_j = pred_pos[:, bi][:, None, :] + pred_r_i - pred_pos[:, bj][:, None, :]
    cnt_safe, n_bar, lam_tot, (r_i_bar, r_j_bar, pred_r_i_bar, pred_r_j_bar) = _conormal_manifolds(
        active, n, lam_n, (r_i, r_j, pred_r_i, pred_r_j)
    )

    im_i, ii_i = spec.inv_mass[bi], spec.inv_inertia[bi]
    im_j, ii_j = spec.inv_mass[bj], spec.inv_inertia[bj]

    def w_of(d):
        return _generalized_inv_mass(q_i[:, None, :], im_i, ii_i, r_i_bar, d) + _generalized_inv_mass(
            q_j[:, None, :], im_j, ii_j, r_j_bar, d
        )

    def point_velocity(v, w, b, r):
        return v[:, b][:, None, :] + torch.linalg.cross(w[:, b][:, None, :], r, dim=-1)

    # relative manifold velocity after the solve, and the approach velocity before it
    v_pt = point_velocity(lin_vel, ang_vel, bi, r_i_bar) - point_velocity(lin_vel, ang_vel, bj, r_j_bar)
    v_pt_pre = point_velocity(v_pre, w_pre, bi, pred_r_i_bar) - point_velocity(v_pre, w_pre, bj, pred_r_j_bar)
    p = _manifold_impulse(v_pt, v_pt_pre, n_bar, w_of, lam_tot, active, dt, contact.restitution,
                          contact.dynamic_friction) / cnt_safe[..., None]  # [B, P, 3]

    p_sum = p.sum(dim=1)
    dv_i = p_sum * im_i * spec.free_pos[bi]
    dw_i = _inv_inertia_world(q_i, ii_i, torch.linalg.cross(r_i_bar, p, dim=-1).sum(dim=1)) * spec.free_rot[bi]
    dv_j = -p_sum * im_j * spec.free_pos[bj]
    dw_j = _inv_inertia_world(q_j, ii_j, torch.linalg.cross(r_j_bar, -p, dim=-1).sum(dim=1)) * spec.free_rot[bj]
    lin_vel = with_bodies(lin_vel, {bi: lin_vel[:, bi] + dv_i, bj: lin_vel[:, bj] + dv_j})
    ang_vel = with_bodies(ang_vel, {bi: ang_vel[:, bi] + dw_i, bj: ang_vel[:, bj] + dw_j})
    return lin_vel, ang_vel


def _velocity_pass_particle_contact(vel, x, v_pre, inv_mass, pc: ParticleSDFContact, lam_p, dt):
    """Restitution and dynamic friction for particles against one SDF.
    lam_p [B, NP]: the normal position corrections summed over the position
    iterations, the per-particle load and the friction budget."""
    phi, n = pc.sdf(x)
    w = inv_mass if inv_mass.ndim == 2 else inv_mass[None]
    gate = ((phi < 1e-4) & (lam_p > 0.0) & (w > 0)).to(x.dtype)
    vn = (vel * n).sum(dim=-1)

    dv = torch.zeros_like(vel)
    if pc.restitution > 0.0:
        vn_pre = (v_pre * n).sum(dim=-1)
        e = torch.where(torch.abs(vn_pre) > 2.0 * GRAVITY_MAG * dt, pc.restitution, 0.0)
        dv = dv + ((-vn + torch.clamp(-e * vn_pre, min=0.0)) * gate)[..., None] * n
    if pc.dynamic_friction > 0.0:
        vt = vel - vn[..., None] * n
        vt_norm = torch.linalg.vector_norm(vt, dim=-1)
        t_dir = vt / torch.clamp(vt_norm, min=1e-9)[..., None]
        # velocity budget: friction dv <= mu * (summed normal correction) / dt
        dv_t = torch.minimum(vt_norm, pc.dynamic_friction * lam_p / dt) * gate
        dv = dv - dv_t[..., None] * t_dir
    return vel + dv


# ---------------------------------------------------------------------------
# the substep
# ---------------------------------------------------------------------------


@spanned("sim.substep")
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
    particle_contacts: Sequence[ParticleSDFContact] = (),
    self_contacts: Sequence[ParticleSelfContact] = (),
    iterations: int = 8,
    max_velocity: float = 1e3,
    gyroscopic: bool = False,
) -> SceneState:
    """One physics substep (dt = sim.dt, run `decimation` times per control
    step). Its parts are spans: `sim.integrate`, per iteration one
    `sim.joints`, one `sim.contacts` per body contact set, one
    `sim.pair_contacts` per pair contact and one `sim.particles`, then
    `sim.velocity`."""
    bodies = state.bodies

    # 1. integrate -----------------------------------------------------------
    with span("sim.integrate"):
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
        pred_pos, pred_quat = pos, quat  # the prediction before the solve (velocity pass)

        if particle_spec is not None and state.particles is not None:
            parts = state.particles
            pv = parts.vel + dt * gravity * (particle_spec.inv_mass > 0)[..., None]
            if particle_spec.lin_damping:
                pv = pv * math.exp(-particle_spec.lin_damping * dt)
            prev_x = parts.pos
            x = parts.pos + dt * pv
        else:
            x = prev_x = pv = None

    # normal lambdas summed over the iterations, only for the contacts that
    # run a velocity pass
    lam_acc = {id(c): 0.0 for c in (*contacts, *pair_contacts, *particle_contacts) if _needs_velocity_pass(c)}

    # 2. position solve --------------------------------------------------------
    for _ in range(iterations):
        if joints is not None:
            with span("sim.joints"):
                pos, quat = _solve_fixed_joints(pos, quat, body_spec, joints)
        for contact in contacts:
            with span("sim.contacts"):
                pos, quat, lam_n = _solve_body_contacts(pos, quat, prev_pos, prev_quat, body_spec, contact)
                if id(contact) in lam_acc:
                    lam_acc[id(contact)] = lam_acc[id(contact)] + lam_n
        for contact in pair_contacts:
            with span("sim.pair_contacts"):
                pos, quat, lam_n = _solve_body_pair_contact(pos, quat, body_spec, contact)
                if id(contact) in lam_acc:
                    lam_acc[id(contact)] = lam_acc[id(contact)] + lam_n
        if x is not None:
            with span("sim.particles"):
                for group in distance_groups:
                    x = _solve_distance_group(x, particle_spec.inv_mass, group, dt)
                for sc in self_contacts:
                    x = _solve_self_contacts(x, particle_spec.inv_mass, sc)
                if attachments is not None:
                    x, pos, quat = _solve_attachments(x, particle_spec.inv_mass, pos, quat, body_spec, attachments)
                for pc in particle_contacts:
                    x, depth = _solve_particle_contact(x, prev_x, pc)
                    if id(pc) in lam_acc:
                        lam_acc[id(pc)] = lam_acc[id(pc)] + depth

    with span("sim.velocity"):
        # 3. velocity recovery -------------------------------------------------
        new_v = (pos - prev_pos) / dt * body_spec.free_pos
        dq_vel = quat_mul(quat, quat_conjugate(prev_quat))
        sign = torch.sign(dq_vel[..., :1] + 1e-12)
        new_w = 2.0 * dq_vel[..., 1:] * sign / dt * body_spec.free_rot

        # 4. velocity pass, only for the contacts that ask for it --------------
        for contact in contacts:
            if id(contact) in lam_acc:
                new_v, new_w = _velocity_pass_body_contact(
                    new_v, new_w, pos, quat, pred_pos, pred_quat, v, w, body_spec, contact, lam_acc[id(contact)], dt
                )
        for contact in pair_contacts:
            if id(contact) in lam_acc:
                new_v, new_w = _velocity_pass_body_pair_contact(
                    new_v, new_w, pos, quat, pred_pos, pred_quat, v, w, body_spec, contact, lam_acc[id(contact)], dt
                )

        new_bodies = RigidBodyState(pos=pos, quat=quat, lin_vel=new_v, ang_vel=new_w)
        if x is None:
            return SceneState(bodies=new_bodies, particles=state.particles)
        new_pv = (x - prev_x) / dt
        for pc in particle_contacts:
            if id(pc) in lam_acc:
                new_pv = _velocity_pass_particle_contact(new_pv, x, pv, particle_spec.inv_mass, pc, lam_acc[id(pc)], dt)
        return SceneState(bodies=new_bodies, particles=ParticleState(pos=x, vel=new_pv))


def step_physics(state: SceneState, body_spec: RigidBodySpec, dt: float, decimation: int, **kwargs) -> SceneState:
    """`decimation` substeps under one control action."""
    for _ in range(decimation):
        state = xpbd_substep(state, body_spec, dt, **kwargs)
    return state
