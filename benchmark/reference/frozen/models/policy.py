"""Diagonal-Gaussian graph policy head (port of `geometry_rl_tpu/models/policy.py`).

- `post_fc=False` (HEPi / EMPN): the backbone's equivariant vector output IS the
  action mean; the std head reads the invariant latent.
- `post_fc=True` (Transformer / GCN / MeshGraphNet): mean = Dense(latent).
- std = softplus(pre + shift) + minimal_std with
  shift = softplus^-1(init_std - minimal_std), or the smooth cap of
  `make_std_fn` when `max_std` is set.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.types import GraphFeatures, HeteroGraph
from ..rl.gaussian import DiagGaussian
from .common import Dense, orthogonal_init


def inverse_softplus(x: float) -> float:
    return math.log(math.expm1(x)) if x < 20.0 else x


def make_std_fn(init_std: float, minimal_std: float, max_std: Optional[float] = None) -> Callable:
    """Std-head activation `pre -> std` (same parametrizations as the
    reference's `make_std_fn`)."""
    if max_std is None:
        shift = inverse_softplus(init_std - minimal_std)

        def std_fn(pre):
            return F.softplus(pre + shift) + minimal_std

        return std_fn

    if not (minimal_std < init_std < max_std):
        raise ValueError(f"need minimal_std < init_std < max_std, got {minimal_std}, {init_std}, {max_std}")
    span = max_std - minimal_std
    shift = inverse_softplus(span * math.atanh((init_std - minimal_std) / span))

    def std_fn(pre):
        return span * torch.tanh(F.softplus(pre + shift) / span) + minimal_std

    return std_fn


class DiagGaussianPolicy(nn.Module):
    """Gaussian head over a graph backbone returning (vector_out, latent
    [B, G, latent_dim]).

    - `contextual_std=False`: the std pre-activation is a bare `pre_std`
      parameter (normal(0.01)), broadcast over the batch.
    - `per_actuator_heads`: separate `mean_i` / `pre_std_i` heads per
      actuator, each reading its own output node's latent.
    - `use_tanh_mean`: tanh on the mean.
    """

    def __init__(
        self,
        backbone: nn.Module,
        latent_dim: int,  # width of the backbone's latent
        action_dim: int,  # TOTAL action dimension
        num_actuators: int = 1,
        share_action_dim: bool = True,
        per_actuator_heads: bool = False,
        contextual_std: bool = True,
        post_fc: bool = True,
        init_std: float = 1.0,
        minimal_std: float = 1e-5,
        max_std: Optional[float] = None,
        use_tanh_mean: bool = False,
        device=None,
    ):
        super().__init__()
        self.backbone = backbone
        self.post_fc, self.contextual_std, self.use_tanh_mean = post_fc, contextual_std, use_tanh_mean
        self.per_actuator_heads, self.num_actuators = per_actuator_heads, num_actuators
        self.init_std, self.minimal_std = init_std, minimal_std
        self.std_fn = make_std_fn(init_std, minimal_std, max_std)
        head_init = orthogonal_init(0.01)

        def std_head(a_dim):
            if contextual_std:
                return Dense(latent_dim, a_dim, kernel_init=head_init, device=device)
            return nn.Parameter(torch.zeros(a_dim, device=device))

        if per_actuator_heads:
            a_dim = action_dim // num_actuators
            for i in range(num_actuators):
                self.add_module(f"mean_{i}", Dense(latent_dim, a_dim, kernel_init=head_init, device=device))
                setattr(self, f"pre_std_{i}", std_head(a_dim))
        else:
            a_dim = action_dim // num_actuators if share_action_dim else action_dim
            if post_fc:
                self.mean = Dense(latent_dim, a_dim, kernel_init=head_init, device=device)
            self.pre_std = std_head(a_dim)

    def reset_loose_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if not self.contextual_std:
            for name, p in self.named_parameters(recurse=False):
                if name.startswith("pre_std"):
                    nn.init.normal_(p, 0.0, 0.01, generator=generator)

    def _pre_std(self, head, hidden: torch.Tensor) -> torch.Tensor:
        """`hidden` [..., latent] -> [..., a_dim]."""
        return head(hidden) if self.contextual_std else head.expand(hidden.shape[:-1] + head.shape)

    def forward(self, graph: HeteroGraph, feats: GraphFeatures) -> DiagGaussian:
        out, hidden = self.backbone(graph, feats)
        B, G = hidden.shape[:2]
        if self.per_actuator_heads:
            hs = [hidden[:, i] for i in range(self.num_actuators)]
            mean = torch.cat([getattr(self, f"mean_{i}")(h) for i, h in enumerate(hs)], dim=-1)
            std = torch.cat([self.std_fn(self._pre_std(getattr(self, f"pre_std_{i}"), h)) for i, h in enumerate(hs)], dim=-1)
        else:
            mean = (self.mean(hidden) if self.post_fc else out.reshape(B, G, -1)).reshape(B, -1)
            std = self.std_fn(self._pre_std(self.pre_std, hidden)).reshape(B, -1)
        if self.use_tanh_mean:
            mean = torch.tanh(mean)
        return DiagGaussian(mean, std)
