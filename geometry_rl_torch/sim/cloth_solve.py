"""Fused XPBD cloth position solve: CUDA kernel and its plain PyTorch version.

Port of `geometry_rl_tpu/sim/pallas_cloth.py`. Two kernels, one per Pallas
entry point, both instantiations of one Hopper design
(`csrc/cloth_solve_common.cuh`: a CTA of 128 threads per env, constraint data
in registers) in the TPU kernel's own operation order: `csrc/cloth_solve.cu`
replaces `cloth_position_solve_tiled` (K2) and `csrc/cloth_solve_env.cu`
replaces `cloth_position_solve` (K1). The plain version
`cloth_position_solve_ref` computes the math of both on [B, PT, 3] tensors
and serves CPU tensors and the parity checks; it takes any shape, the kernels
those `check_kernel_limits` accepts.

Gripper cubes enter the solve as pseudo-particles P..P+G-1 (their rotation is
locked and they attach at their centre of mass, so their rigid dynamics reduce
to point dynamics). Each iteration runs: one compliant distance solve per
conflict-free group, the optional all-pairs self-collision pass, the rest-0
corner <-> gripper attachments, and the capsule hook contact with Coulomb
friction on cloth particles only.

A call of the env's solve is the span `kernels.cloth_solve`; each launch
counts `kernels.cloth_solve` or `kernels.cloth_solve_env`.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.trace import count, spanned

# the kernels' limits (`csrc/cloth_solve_common.cuh`): a CTA of KERNEL_THREADS
# threads per env, thread t owns constraint t of every group and particles t
# and t + KERNEL_THREADS
KERNEL_THREADS = 128
MAX_GROUPS = 16
MAX_GROUP_SIZE = KERNEL_THREADS
MAX_PARTICLES = 2 * KERNEL_THREADS

# f32 operations per item and XPBD iteration, counted from the kernels'
# formulas in K2's operation order, the cheaper one (sqrt, divide, min and max
# count as one each). Every iteration: a distance constraint, a corner
# attachment, the hook test of a cloth particle (clamp, distance, phi < 0), the
# test of a self-collision pair (distance, violation, > 0) and a particle's
# self-collision update. Only where the test holds: the contact response of a
# particle on the hook, the correction of a violating pair.
OPS_PER_CONSTRAINT = 31
OPS_PER_ATTACHMENT = 29
OPS_PER_HOOK_TEST = 14
OPS_PER_CONTACT = 42
OPS_PER_SELF_TEST = 18
OPS_PER_SELF_HIT = 13
OPS_PER_SELF_UPDATE = 7
# once per call: a constraint's divisor max(w_i + w_j + alpha, 1e-12), an
# attachment's max(w_p + w_b, 1e-12), a group's alpha = compliance / dt^2
OPS_PER_CONSTRAINT_DIVISOR = 3
OPS_PER_ATTACHMENT_DIVISOR = 2
OPS_PER_GROUP_ALPHA = 1


class ClothSolveSpec(NamedTuple):
    """Static solver description (the reference's `ClothSolveSpec`)."""

    group_sizes: Tuple[int, ...]
    group_compliance: Tuple[float, ...]
    num_particles: int  # P (cloth only)
    num_bodies: int  # G pseudo-particles appended after P
    iterations: int
    dt: float
    hook_radius: float
    hook_half_len: float
    hook_friction: float
    self_min_dist: float = 0.0  # 0 = self-collision off


class ClothGroups(NamedTuple):
    """All distance groups packed once: group g owns constraints
    offset[g]:offset[g+1] of the concatenated arrays."""

    i: torch.Tensor  # [C_total] int32
    j: torch.Tensor  # [C_total] int32
    rest: torch.Tensor  # [C_total] f32
    mask: torch.Tensor  # [B, C_total] f32
    offset: torch.Tensor  # [n_groups + 1] int32
    compliance: torch.Tensor  # [n_groups] f32


def check_conflict_free(group_topology: Sequence) -> None:
    """Raise unless every group touches each particle at most once — the
    condition that lets the kernel solve a group's constraints in parallel,
    each thread writing its two particles with no atomics."""
    for g in range(len(group_topology) // 3):
        both = np.concatenate([torch.as_tensor(group_topology[3 * g + k]).cpu().numpy() for k in (0, 1)])
        if np.unique(both).size != both.size:
            raise ValueError(f"distance group {g} is not conflict-free: a particle appears twice")


def check_kernel_limits(spec: ClothSolveSpec, att_particle: Optional[Sequence[int]] = None) -> None:
    """Raise for a shape the CUDA kernels do not take: more than 128
    constraints in a group, more than 16 groups, more than 256 particles
    (P + G), or attachment particles that repeat or are not cloth particles
    (each cloth particle's owner thread does its attachment and its hook
    contact in one pass). The plain version takes any shape."""
    n_g = len(spec.group_sizes)
    if n_g > MAX_GROUPS:
        raise ValueError(f"the cloth kernels take at most {MAX_GROUPS} distance groups, got {n_g}")
    big = [g for g, n in enumerate(spec.group_sizes) if n > MAX_GROUP_SIZE]
    if big:
        raise ValueError(f"the cloth kernels take at most {MAX_GROUP_SIZE} constraints per group; "
                         f"group {big[0]} has {spec.group_sizes[big[0]]}")
    pt = spec.num_particles + spec.num_bodies
    if pt > MAX_PARTICLES:
        raise ValueError(f"the cloth kernels take at most {MAX_PARTICLES} particles (P + G), got {pt}")
    if att_particle is not None:
        att = [int(a) for a in att_particle]
        if len(att) != spec.num_bodies or len(set(att)) != len(att) or not all(0 <= a < spec.num_particles for a in att):
            raise ValueError(f"attachment particles must be {spec.num_bodies} distinct cloth indices in "
                             f"[0, {spec.num_particles}), got {att}")


# att_particle tensors already checked, by id: the version of the tensor that
# passed. The wrappers read a tensor's values from the card once, not per
# launch; an entry goes when its tensor dies, before its id can be reused.
_ATT_CHECKED: Dict[int, int] = {}


def _check_att_once(spec: ClothSolveSpec, att_particle: torch.Tensor) -> None:
    key = id(att_particle)
    if _ATT_CHECKED.get(key) == att_particle._version:
        return
    check_kernel_limits(spec, att_particle.tolist())
    if key not in _ATT_CHECKED:
        weakref.finalize(att_particle, _ATT_CHECKED.pop, key, None)
    _ATT_CHECKED[key] = att_particle._version


def solve_cost(spec: ClothSolveSpec, B: int, contacts: int = 0, self_hits: int = 0) -> Tuple[int, int]:
    """(bytes, f32 operations) of one solve of B envs: every operand read once
    and the output written once; the operations every iteration does, plus
    the contact responses and self-collision corrections these inputs need.
    `contacts` and `self_hits` count them over all envs and iterations, as
    `cloth_position_solve_ref(..., events=...)` reports them; left at 0 the
    count is the least any input needs."""
    P, G = spec.num_particles, spec.num_bodies
    pt, n_g, c = P + G, len(spec.group_sizes), int(sum(spec.group_sizes))
    f32 = i32 = 4
    nbytes = (
        3 * B * pt * 3 * f32  # x, prev_x, out
        + B * pt * f32  # inv_mass
        + B * 3 * f32  # hanger
        + B * G * f32  # att_body_w
        + G * i32  # att_particle
        + c * (2 * i32 + f32)  # groups.i, groups.j, groups.rest
        + B * c * f32  # groups.mask
        + (n_g + 1) * i32 + n_g * f32  # groups.offset, groups.compliance
    )
    per_call = c * OPS_PER_CONSTRAINT_DIVISOR + G * OPS_PER_ATTACHMENT_DIVISOR + n_g * OPS_PER_GROUP_ALPHA
    per_iter = c * OPS_PER_CONSTRAINT + G * OPS_PER_ATTACHMENT + P * OPS_PER_HOOK_TEST
    if spec.self_min_dist > 0.0:
        nbytes += pt * pt * f32 + B * pt * f32  # self_pair_mask, self_active
        per_iter += pt * pt * OPS_PER_SELF_TEST + pt * OPS_PER_SELF_UPDATE
    flops = B * (per_call + spec.iterations * per_iter) + contacts * OPS_PER_CONTACT + self_hits * OPS_PER_SELF_HIT
    return nbytes, flops


def pack_groups(spec: ClothSolveSpec, group_topology: Sequence[torch.Tensor], group_masks: Sequence[torch.Tensor]) -> ClothGroups:
    """Reference operand layout (per group i, j, rest interleaved; masks
    [B, C] per group) -> one `ClothGroups`. Checks the group sizes, the index
    range and conflict-freedom once, on the host: the kernel indexes shared
    memory with these indices unchecked."""
    n_g = len(spec.group_sizes)
    if len(group_topology) != 3 * n_g or len(group_masks) != n_g:
        raise ValueError("group_topology needs (i, j, rest) per group and group_masks one mask per group")
    check_conflict_free(group_topology)
    pt = spec.num_particles + spec.num_bodies
    for g in range(n_g):
        for k in (0, 1):
            idx = group_topology[3 * g + k]
            if idx.shape != (spec.group_sizes[g],) or int(idx.min()) < 0 or int(idx.max()) >= pt:
                raise ValueError(f"distance group {g}: expected {spec.group_sizes[g]} indices in [0, {pt})")
    device = group_masks[0].device
    offset = np.concatenate([[0], np.cumsum(spec.group_sizes)]).astype(np.int32)
    return ClothGroups(
        i=torch.cat([group_topology[3 * g].to(torch.int32) for g in range(n_g)]).contiguous(),
        j=torch.cat([group_topology[3 * g + 1].to(torch.int32) for g in range(n_g)]).contiguous(),
        rest=torch.cat([group_topology[3 * g + 2].float() for g in range(n_g)]).contiguous(),
        mask=torch.cat([m.float() for m in group_masks], dim=1).contiguous(),
        offset=torch.as_tensor(offset, device=device),
        compliance=torch.tensor(spec.group_compliance, dtype=torch.float32, device=device),
    )


def cloth_position_solve_ref(
    spec: ClothSolveSpec,
    x: torch.Tensor,  # [B, PT, 3]
    prev_x: torch.Tensor,  # [B, PT, 3]
    inv_mass: torch.Tensor,  # [B, PT]
    hanger: torch.Tensor,  # [B, 3]
    att_body_w: torch.Tensor,  # [B, G]
    att_particle: torch.Tensor,  # [G] int
    groups: ClothGroups,
    self_pair_mask: Optional[torch.Tensor] = None,  # [PT, PT]
    self_active: Optional[torch.Tensor] = None,  # [B, PT]
    *,
    events: Optional[Dict[str, int]] = None,
) -> torch.Tensor:
    """Plain PyTorch position solve, batched over envs: the math of the
    kernel and of `_solve_tile`, in the reference's operation order. A dict
    passed as `events` receives "contacts" (cloth particles on the hook) and
    "self_hits" (violating self-collision pairs), summed over envs and
    iterations: the data-dependent work that `solve_cost` counts."""
    P, G = spec.num_particles, spec.num_bodies
    dt2 = spec.dt * spec.dt
    W = inv_mass
    offs = groups.offset.tolist()
    att_p = att_particle.long()
    att_b = torch.arange(P, P + G, device=x.device)
    wp = W[:, att_p]  # [B, G]
    att_denom = torch.clamp(wp + att_body_w, min=1e-12)

    dgroups = []
    for g in range(len(spec.group_sizes)):
        gi = groups.i[offs[g] : offs[g + 1]].long()
        gj = groups.j[offs[g] : offs[g + 1]].long()
        wi, wj = W[:, gi], W[:, gj]  # [B, C]
        denom = torch.clamp(wi + wj + spec.group_compliance[g] / dt2, min=1e-12)
        dgroups.append((gi, gj, groups.rest[offs[g] : offs[g + 1]], groups.mask[:, offs[g] : offs[g + 1]], wi, wj, denom))

    def norm3(d):
        return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2])

    def pair_update(x, ia, ib, c, lam, wa, wb, inv):
        # c [B, n, 3] = x[ia] - x[ib]; x[ia] += lam*wa*inv*c, x[ib] -= lam*wb*inv*c
        x = x.index_add(1, ia, (lam * wa * inv)[..., None] * c)
        return x.index_add(1, ib, -((lam * wb * inv)[..., None] * c))

    def distance_pass(x, gi, gj, rest, mask, wi, wj, denom):
        d = x[:, gi] - x[:, gj]
        dist = norm3(d)
        inv = 1.0 / torch.clamp(dist, min=1e-9)
        lam = -(dist - rest) * mask / denom
        return pair_update(x, gi, gj, d, lam, wi, wj, inv)

    def attachment_pass(x):
        c = x[:, att_p] - x[:, att_b]
        c_norm = norm3(c)
        inv = 1.0 / torch.clamp(c_norm, min=1e-9)
        return pair_update(x, att_p, att_b, c, -c_norm / att_denom, wp, att_body_w, inv)

    def contact_pass(x):
        rel1 = x[..., 1] - hanger[:, None, 1]
        y = torch.clamp(rel1, 0.0, 2 * spec.hook_half_len)
        d = torch.stack([x[..., 0] - hanger[:, None, 0], rel1 - y, x[..., 2] - hanger[:, None, 2]], dim=-1)
        dist = norm3(d)
        n = d * (1.0 / torch.clamp(dist, min=1e-9))[..., None]
        phi = dist - spec.hook_radius
        pen = torch.clamp(phi, max=0.0)
        disp = x - prev_x
        dot = disp[..., 0] * n[..., 0] + disp[..., 1] * n[..., 1] + disp[..., 2] * n[..., 2]
        disp_t = disp - dot[..., None] * n
        t_norm = norm3(disp_t)
        scale = torch.clamp(spec.hook_friction * (-pen) / torch.clamp(t_norm, min=1e-9), max=1.0)
        active = (phi < 0.0).to(x.dtype)
        active[:, P:] = 0.0  # pseudo-bodies have no hook contact
        if events is not None:
            events["contacts"] += int(active.sum().item())
        return x + active[..., None] * (-pen[..., None] * n - scale[..., None] * disp_t)

    def self_pass(x):
        d = x[:, :, None, :] - x[:, None, :, :]  # [B, PT, PT, 3]
        dist = torch.sqrt(((d + 1e-12) ** 2).sum(-1))
        pair_w = W[:, :, None] + W[:, None, :]
        viol = torch.clamp(spec.self_min_dist - dist, min=0.0) * self_pair_mask
        viol = viol * self_active[:, :, None] * self_active[:, None, :]
        n = d / torch.clamp(dist, min=1e-9)[..., None]
        corr = viol / torch.clamp(pair_w, min=1e-12) * W[:, :, None]
        hits = (viol > 0).to(x.dtype).sum(-1)
        if events is not None:
            events["self_hits"] += int(hits.sum().item())
        counts = torch.clamp(hits, min=1.0)
        return x + (corr[..., None] * n).sum(2) / counts[..., None]

    if events is not None:
        events.update(contacts=0, self_hits=0)
    x = x.clone()
    for _ in range(spec.iterations):
        for dg in dgroups:
            x = distance_pass(x, *dg)
        if spec.self_min_dist > 0.0:
            x = self_pass(x)
        x = attachment_pass(x)
        x = contact_pass(x)
    return x


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# the C entry both kernel files export (`CLOTH_SOLVE_C_ENTRY` in
# `csrc/cloth_solve_common.cuh`): 15 pointers, 6 ints, 5 floats, the stream
KERNEL_ARGTYPES = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 6 + [ctypes.c_float] * 5 + [ctypes.c_void_p]


def _kernel_fn(name: str):
    """The ctypes entry `<name>_launch` of `csrc/<name>.cu`, built at first use."""
    from ..cuda_build import load_library

    fn = getattr(load_library(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes, fn.restype = KERNEL_ARGTYPES, ctypes.c_int
    return fn


def _kernel_operands(
    name: str,
    spec: ClothSolveSpec,
    x: torch.Tensor,
    prev_x: torch.Tensor,
    inv_mass: torch.Tensor,
    hanger: torch.Tensor,
    att_body_w: torch.Tensor,
    att_particle: torch.Tensor,
    groups: ClothGroups,
    self_pair_mask: Optional[torch.Tensor] = None,
    self_active: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, list]:
    """Check the kernels' limits and the device, dtype (f32 / i32), shape and
    contiguity of every operand, raising on anything the kernels do not take;
    return the output tensor and the argument list both C entry points
    share."""
    check_kernel_limits(spec)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    B, PT, _ = x.shape
    P, G = spec.num_particles, spec.num_bodies
    n_g, c_total = len(spec.group_sizes), int(sum(spec.group_sizes))
    if PT != P + G:
        raise ValueError(f"x has {PT} particles, spec says {P} + {G}")
    f32, i32 = torch.float32, torch.int32
    _check("x", x, f32, (B, PT, 3), dev)
    _check("prev_x", prev_x, f32, (B, PT, 3), dev)
    _check("inv_mass", inv_mass, f32, (B, PT), dev)
    _check("hanger", hanger, f32, (B, 3), dev)
    _check("att_body_w", att_body_w, f32, (B, G), dev)
    _check("att_particle", att_particle, i32, (G,), dev)
    _check("groups.i", groups.i, i32, (c_total,), dev)
    _check("groups.j", groups.j, i32, (c_total,), dev)
    _check("groups.rest", groups.rest, f32, (c_total,), dev)
    _check("groups.mask", groups.mask, f32, (B, c_total), dev)
    _check("groups.offset", groups.offset, i32, (n_g + 1,), dev)
    _check("groups.compliance", groups.compliance, f32, (n_g,), dev)
    _check_att_once(spec, att_particle)
    if spec.self_min_dist > 0.0:
        if self_pair_mask is None or self_active is None:
            raise ValueError("self-collision is on: self_pair_mask and self_active are required")
        _check("self_pair_mask", self_pair_mask, f32, (PT, PT), dev)
        _check("self_active", self_active, f32, (B, PT), dev)
        pm_ptr, act_ptr = self_pair_mask.data_ptr(), self_active.data_ptr()
    else:
        pm_ptr = act_ptr = None
    out = torch.empty_like(x)
    args = [
        x.data_ptr(), prev_x.data_ptr(), inv_mass.data_ptr(), hanger.data_ptr(),
        att_body_w.data_ptr(), att_particle.data_ptr(), groups.i.data_ptr(),
        groups.j.data_ptr(), groups.rest.data_ptr(), groups.mask.data_ptr(),
        groups.offset.data_ptr(), groups.compliance.data_ptr(), pm_ptr, act_ptr,
        out.data_ptr(), B, P, G, n_g, c_total, spec.iterations, spec.dt,
        spec.hook_radius, spec.hook_half_len, spec.hook_friction, spec.self_min_dist,
    ]
    return out, args


def _launch(name: str, out: torch.Tensor, args: list) -> torch.Tensor:
    fn = _kernel_fn(name)
    with torch.cuda.device(out.device):
        err = fn(*args, torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    count(f"kernels.{name}")
    return out


def cloth_position_solve_cuda(spec: ClothSolveSpec, x: torch.Tensor, *operands) -> torch.Tensor:
    """Launch `csrc/cloth_solve.cu` (K2's port, K2's operation order) on the
    current stream. Operands as `cloth_position_solve_ref`."""
    out, args = _kernel_operands("cloth_solve", spec, x, *operands)
    return _launch("cloth_solve", out, args)


def cloth_position_solve_env_cuda(spec: ClothSolveSpec, x: torch.Tensor, *operands) -> torch.Tensor:
    """Launch `csrc/cloth_solve_env.cu` (K1's port, K1's operation order) on
    the current stream. Operands as `cloth_position_solve_ref`."""
    out, args = _kernel_operands("cloth_solve_env", spec, x, *operands)
    return _launch("cloth_solve_env", out, args)


KERNELS = {"tiled": cloth_position_solve_cuda, "per_env": cloth_position_solve_env_cuda}


@spanned("kernels.cloth_solve")
def cloth_position_solve(spec: ClothSolveSpec, x: torch.Tensor, *args, kernel: str = "tiled", **kwargs) -> torch.Tensor:
    """The env's solve: for CUDA tensors the kernel named by `kernel`
    ("tiled": K2's port, "per_env": K1's), for CPU tensors the plain version,
    which both kernels compute. No fallback: a CUDA tensor launches the kernel
    or raises."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {sorted(KERNELS)}, got {kernel!r}")
    if x.device.type == "cpu":
        return cloth_position_solve_ref(spec, x, *args, **kwargs)
    return KERNELS[kernel](spec, x, *args, **kwargs)
