"""Observation transform pipeline (port of `geometry_rl_tpu/rl/obs_pipeline.py`):

  Reshape([-1,3]) -> NDVecNorm(position/velocity vectors, shared (3,) stats)
  -> VecNorm(scalars, per-dim) -> Clip(+-20)

Stats update only during collection (`update=True`); eval freezes them.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from .normalizer import VecNormState, vecnorm_init, vecnorm_normalize, vecnorm_update

CLIP = 20.0
DECAY = 0.99999
EPS = 1e-2


class ObsNormState(NamedTuple):
    position: VecNormState  # (3,) shared stats over all 3-vectors
    velocity: VecNormState  # (3,)
    scalars: VecNormState  # (D_scalars,) per-dim


def obs_norm_init(scalar_dim: int, device=None) -> ObsNormState:
    return ObsNormState(
        position=vecnorm_init((3,), device),
        velocity=vecnorm_init((3,), device),
        scalars=vecnorm_init((scalar_dim,), device),
    )


def obs_norm_update(state: ObsNormState, obs: Dict[str, torch.Tensor]) -> ObsNormState:
    """Fold one batch of raw observations into the running stats."""
    B = obs["position_vectors"].shape[0]
    return ObsNormState(
        position=vecnorm_update(state.position, obs["position_vectors"].reshape(B, -1, 3), DECAY),
        velocity=vecnorm_update(state.velocity, obs["velocity_vectors"].reshape(B, -1, 3), DECAY),
        scalars=vecnorm_update(state.scalars, obs["scalars"], DECAY),
    )


def obs_norm_apply(state: ObsNormState, obs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The transformed observation dict: norm_* keys + clipping."""
    shape_p = obs["position_vectors"].shape
    shape_v = obs["velocity_vectors"].shape
    npos = vecnorm_normalize(state.position, obs["position_vectors"].reshape(shape_p[:-1] + (-1, 3)), EPS)
    nvel = vecnorm_normalize(state.velocity, obs["velocity_vectors"].reshape(shape_v[:-1] + (-1, 3)), EPS)
    nsc = vecnorm_normalize(state.scalars, obs["scalars"], EPS)

    def clip(x):
        return torch.clamp(x, -CLIP, CLIP)

    return {
        "scalars": clip(nsc),
        "position_vectors": clip(obs["position_vectors"]),
        "velocity_vectors": clip(obs["velocity_vectors"]),
        "norm_position_vectors": clip(npos.reshape(shape_p)),
        "norm_velocity_vectors": clip(nvel.reshape(shape_v)),
        "infos": obs["infos"],
    }


def obs_norm_step(
    state: ObsNormState, obs: Dict[str, torch.Tensor], update: bool = True
) -> Tuple[ObsNormState, Dict[str, torch.Tensor]]:
    """Update-then-normalize, matching the reference's call order."""
    if update:
        state = obs_norm_update(state, obs)
    return state, obs_norm_apply(state, obs)
