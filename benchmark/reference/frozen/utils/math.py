"""Geometry math: quaternions, rigid transforms, uniform sampling, S1 / S2
grids (port of `geometry_rl_tpu/utils/math.py`). Quaternions are (w, x, y, z);
functions broadcast over leading dims.
"""

from __future__ import annotations

import math

import torch


def quat_identity(shape: tuple = (), device=None) -> torch.Tensor:
    """Identity quaternion broadcast to `shape + (4,)`."""
    q = torch.zeros(4, dtype=torch.float32, device=device)
    q[0].fill_(1.0)  # a fill on the device: no copy from the host, which would synchronise
    return q.expand(tuple(shape) + (4,))


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=eps)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


# quat_mul's terms: component c is the signed sum, left to right, of the
# products q1[i] * q2[j] for the (i, j) pairs of row c of _QMUL_PAIRS
_QMUL_PAIRS = ((0, 0), (1, 1), (2, 2), (3, 3)), ((0, 1), (1, 0), (2, 3), (3, 2)), \
    ((0, 2), (1, 3), (2, 0), (3, 1)), ((0, 3), (1, 2), (2, 1), (3, 0))
_QMUL_INDEX = [[4 * i + j for i, j in row] for row in _QMUL_PAIRS]
_QMUL_SIGN = [[1.0, -1.0, -1.0, -1.0], [1.0, 1.0, 1.0, -1.0], [1.0, -1.0, 1.0, 1.0], [1.0, 1.0, -1.0, 1.0]]
_QMUL_CONST = {}


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 ⊗ q2, wxyz convention:
        w1 w2 - x1 x2 - y1 y2 - z1 z2,  w1 x2 + x1 w2 + y1 z2 - z1 y2,
        w1 y2 - x1 z2 + y1 w2 + z1 x2,  w1 z2 + x1 y2 - y1 x2 + z1 w2.
    The 16 products come from one outer product and each sum runs left to
    right, so the result is bit-identical to the written-out formula in 6
    device kernels instead of 28 (the rigid solver calls this ~200 times a
    control step)."""
    key = (q1.device, q1.dtype)
    if key not in _QMUL_CONST:  # made on a device's first call, then reused
        _QMUL_CONST[key] = (torch.tensor(_QMUL_INDEX, device=q1.device).reshape(-1),
                            torch.tensor(_QMUL_SIGN, dtype=q1.dtype, device=q1.device))
    index, sign = _QMUL_CONST[key]
    outer = (q1[..., :, None] * q2[..., None, :]).flatten(-2)  # [..., 16]
    terms = outer[..., index].unflatten(-1, (4, 4)) * sign  # [..., 4 components, 4 terms]
    return ((terms[..., 0] + terms[..., 1]) + terms[..., 2]) + terms[..., 3]


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by quaternion(s) q. Shapes broadcast on leading dims."""
    qw = q[..., :1]
    qv = q[..., 1:]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_inv_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the inverse of q."""
    return quat_apply(quat_conjugate(q), v)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quaternion from unit axis [..., 3] and angle [...]."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def quat_from_euler_xyz(roll: torch.Tensor, pitch: torch.Tensor, yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion from XYZ (roll-pitch-yaw) Euler angles (extrinsic x-y-z)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] from quaternion [..., 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = (
        (1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)),
        (2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)),
        (2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)),
    )
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_error_magnitude(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Rotation angle (radians, in [0, pi]) between two quaternions: the
    axis-angle magnitude of q1 ⊗ q2*, in the robust atan2 form."""
    dq = quat_mul(q1, quat_conjugate(q2))
    sin_half = torch.linalg.vector_norm(dq[..., 1:], dim=-1)
    cos_half = torch.abs(dq[..., 0])
    return 2.0 * torch.atan2(sin_half, cos_half)


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """The yaw-only quaternion of q (identity where q has no yaw part)."""
    w, z = q[..., 0], q[..., 3]
    norm = torch.sqrt(w * w + z * z)
    safe = norm > 1e-9
    w = torch.where(safe, w / torch.clamp(norm, min=1e-9), 1.0)
    z = torch.where(safe, z / torch.clamp(norm, min=1e-9), 0.0)
    zeros = torch.zeros_like(w)
    return torch.stack([w, zeros, zeros, z], dim=-1)


def quat_apply_yaw(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by the yaw component of q only."""
    return quat_apply(yaw_quat(q), v)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt: float) -> torch.Tensor:
    """First-order quaternion integration under world-frame angular velocity."""
    dq = 0.5 * quat_mul(torch.cat([torch.zeros_like(omega[..., :1]), omega], dim=-1), q)
    return quat_normalize(q + dt * dq)


def transform_points(points: torch.Tensor, pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """World-transform local points: R(quat) @ p + pos. points [..., N, 3];
    pos [..., 3] and quat [..., 4] broadcast over N."""
    return quat_apply(quat[..., None, :], points) + pos[..., None, :]


def inverse_transform_points(points: torch.Tensor, pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """The inverse of `transform_points`: R(quat)^T @ (p - pos)."""
    return quat_inv_apply(quat[..., None, :], points - pos[..., None, :])


def sample_uniform(generator: torch.Generator, lower, upper, shape: tuple, device=None) -> torch.Tensor:
    """Uniform sample in [lower, upper), drawn from `generator`."""
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (upper - lower) + lower


def fibonacci_lattice(n: int, offset: float = 0.5, upper_hemisphere: bool = False, device=None) -> torch.Tensor:
    """~uniform S2 grid via the Fibonacci spiral -> [n, 3] (f32, as the
    reference computes it; `fmod` equals the floor-mod there since every
    operand is non-negative)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    theta = torch.fmod(math.pi * i * (1 + math.sqrt(5.0)), 2 * math.pi)
    scale = 1.0 if upper_hemisphere else 2.0
    phi = torch.arccos(1 - scale * (i + offset) / (n - 1 + 2 * offset))
    return torch.stack(
        [torch.cos(theta) * torch.sin(phi), torch.sin(theta) * torch.sin(phi), torch.cos(phi)],
        dim=-1,
    )


def s1_grid(n: int, device=None) -> torch.Tensor:
    """n equally spaced points on S1 -> [n, 2]."""
    angles = torch.linspace(0.0, 2 * math.pi - (2 * math.pi / n), n, dtype=torch.float32, device=device)
    return torch.stack([torch.cos(angles), torch.sin(angles)], dim=1)


def orientation_grid(dim: int, n: int, upper_hemisphere: bool = False, device=None) -> torch.Tensor:
    """The PONITA grid: S1 (dim=2) or S2 (dim=3)."""
    if dim == 2:
        return s1_grid(n, device)
    if dim == 3:
        return fibonacci_lattice(n, upper_hemisphere=upper_hemisphere, device=device)
    raise ValueError("Only S1 (dim=2) and S2 (dim=3) are supported.")
