"""Running observation normalizers as explicit state (port of
`geometry_rl_tpu/rl/normalizer.py`: VecNorm / NDVecNorm and MinMax).

Statistics are shared across all leading dims beyond the stat shape, so one
(3,) statistic normalizes every 3-vector. `update` returns new state;
`normalize` is read-only.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class VecNormState(NamedTuple):
    """Decayed running sums for mean/var normalization. Shapes = stat shape."""

    sum: torch.Tensor
    ssq: torch.Tensor
    count: torch.Tensor  # scalar


def vecnorm_init(stat_shape: tuple, device=None, dtype=torch.float32) -> VecNormState:
    return VecNormState(
        sum=torch.zeros(stat_shape, dtype=dtype, device=device),
        ssq=torch.zeros(stat_shape, dtype=dtype, device=device),
        count=torch.zeros((), dtype=dtype, device=device),
    )


def vecnorm_update(state: VecNormState, x: torch.Tensor, decay: float = 0.99999) -> VecNormState:
    """Fold a batch into the running stats; every dim of `x` beyond the stat
    shape is reduced."""
    reduce_dims = tuple(range(x.ndim - state.sum.ndim))
    n = 1
    for d in reduce_dims:
        n *= x.shape[d]
    s, q = x.sum(dim=reduce_dims), (x * x).sum(dim=reduce_dims)
    return VecNormState(sum=state.sum * decay + s, ssq=state.ssq * decay + q, count=state.count * decay + n)


def vecnorm_mean_std(state: VecNormState, eps: float = 1e-2) -> Tuple[torch.Tensor, torch.Tensor]:
    count = torch.clamp(state.count, min=1.0)
    mean = state.sum / count
    var = state.ssq / count - mean**2
    return mean, torch.sqrt(torch.clamp(var, min=eps))


def vecnorm_normalize(state: VecNormState, x: torch.Tensor, eps: float = 1e-2) -> torch.Tensor:
    """(x - mean) / sqrt(max(var, eps)) with stats broadcast over leading dims."""
    mean, std = vecnorm_mean_std(state, eps)
    return (x - mean) / std


class MinMaxState(NamedTuple):
    min: torch.Tensor
    max: torch.Tensor
    count: torch.Tensor


def minmax_init(stat_shape: tuple, device=None, dtype=torch.float32) -> MinMaxState:
    return MinMaxState(
        min=torch.zeros(stat_shape, dtype=dtype, device=device),
        max=torch.zeros(stat_shape, dtype=dtype, device=device),
        count=torch.zeros((), dtype=dtype, device=device),
    )


def minmax_update(state: MinMaxState, x: torch.Tensor) -> MinMaxState:
    reduce_dims = tuple(range(x.ndim - state.min.ndim))
    n = 1
    for d in reduce_dims:
        n *= x.shape[d]
    return MinMaxState(
        min=torch.minimum(state.min, torch.amin(x, dim=reduce_dims) if reduce_dims else x),
        max=torch.maximum(state.max, torch.amax(x, dim=reduce_dims) if reduce_dims else x),
        count=state.count + n,
    )


def minmax_normalize(state: MinMaxState, x: torch.Tensor, out_min: float = -1.0, out_max: float = 1.0) -> torch.Tensor:
    """Scale into [out_min, out_max] by the global max range over all stat
    dims."""
    scale = (out_max - out_min) / torch.clamp(torch.max(state.max - state.min), min=1e-8)
    return (x - state.min) * scale + out_min
