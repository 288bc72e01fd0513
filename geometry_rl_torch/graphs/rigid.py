"""Observation splitting and the training-noise augmentation shared by the
graph builders (the `split_group` and `apply_training_noise` parts of
`geometry_rl_tpu/graphs/rigid.py`; the rigid builder is not ported yet)."""

from __future__ import annotations

from typing import Dict

import torch

from ..envs.base import ObsSpec


def split_group(obs: torch.Tensor, spec: ObsSpec, group: str) -> Dict[str, torch.Tensor]:
    """Split a flat group tensor into named terms."""
    out = {}
    start = 0
    for name, dim in zip(spec.names[group], spec.dims[group]):
        out[name] = obs[..., start : start + dim]
        start += dim
    return out


def apply_training_noise(vectors: Dict[str, torch.Tensor], generator: torch.Generator, std: float) -> Dict[str, torch.Tensor]:
    """Gaussian data-augmentation noise on the per-node vector features,
    drawn from `generator` node type by node type: applied only on training
    forwards, drawn fresh per network update."""
    return {
        nt: v + std * torch.randn(v.shape, generator=generator, dtype=v.dtype, device=v.device)
        for nt, v in vectors.items()
    }
