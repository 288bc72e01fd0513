"""Scene state and specs for the batched simulator (port of
`geometry_rl_tpu/sim/types.py`).

All state tensors carry a leading env axis B; quaternions are (w, x, y, z).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class RigidBodyState(NamedTuple):
    """Batched rigid body states: [B, NB, ...]."""

    pos: torch.Tensor  # [B, NB, 3]
    quat: torch.Tensor  # [B, NB, 4] (w,x,y,z)
    lin_vel: torch.Tensor  # [B, NB, 3]
    ang_vel: torch.Tensor  # [B, NB, 3] world frame


class ParticleState(NamedTuple):
    """Batched particle states (cloth vertices): [B, NP, ...]."""

    pos: torch.Tensor  # [B, NP, 3]
    vel: torch.Tensor  # [B, NP, 3]


class SceneState(NamedTuple):
    bodies: RigidBodyState
    particles: Optional[ParticleState] = None


class RigidBodySpec(NamedTuple):
    """Static per-body parameters: [NB, ...] (broadcast over envs)."""

    inv_mass: torch.Tensor  # [NB] 0 = kinematic/static
    inv_inertia: torch.Tensor  # [NB, 3] diagonal body-frame inverse inertia
    gravity_scale: torch.Tensor  # [NB]
    lin_damping: torch.Tensor  # [NB]
    ang_damping: torch.Tensor  # [NB]
    free_pos: torch.Tensor  # [NB, 3] 1.0 = free axis, 0.0 = locked
    free_rot: torch.Tensor  # [NB, 3]


class FixedJointSpec(NamedTuple):
    """Fixed joints welding body pairs: each drives world(body_a, local_pos_a)
    onto world(body_b, local_pos_b) and locks the relative orientation
    `rel_quat` (q_rel = conj(q_a) * q_b at attach time)."""

    body_a: torch.Tensor  # [NJ] int body indices
    body_b: torch.Tensor  # [NJ]
    local_pos_a: torch.Tensor  # [NJ, 3]
    local_pos_b: torch.Tensor  # [NJ, 3]
    rel_quat: torch.Tensor  # [NJ, 4] or [B, NJ, 4]
    # the static sums into bodies (`sim/xpbd.joint_sum_order`; made on the spot if None):
    sum_order: Optional[torch.Tensor] = None  # [NB, D] rows of [a-side; b-side; a zero row]
    inv_count: Optional[torch.Tensor] = None  # [2 NJ + 1] each row's 1/K (the zero row's 1)


def axis_mask_from_bits(bits: int, device=None) -> torch.Tensor:
    """orbit locked-axis bitmask -> free-axis multiplier (1 free, 0 locked)."""
    return torch.tensor([0.0 if bits & b else 1.0 for b in (1, 2, 4)], dtype=torch.float32, device=device)


def box_inertia(mass: float, size, device=None) -> torch.Tensor:
    """Diagonal inertia of a solid box with full extents `size`."""
    sx, sy, sz = size
    return torch.tensor(
        [
            mass / 12.0 * (sy * sy + sz * sz),
            mass / 12.0 * (sx * sx + sz * sz),
            mass / 12.0 * (sx * sx + sy * sy),
        ],
        dtype=torch.float32,
        device=device,
    )
