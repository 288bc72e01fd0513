"""Flat-observation MLP agents: the non-graph baseline family (port of
`geometry_rl_tpu/models/mlp_policy.py`).

A plain MLP over the flattened normalised observation with the diagonal-
Gaussian head of the graph policies (`make_std_fn`). Both modules take
`(graph=None, obs)` from `graphs.flat.FlatObsBuilder`, so the Trainer treats
them like graph agents. They compute in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..rl.gaussian import DiagGaussian
from .common import ActivatedMLP, Dense, orthogonal_init
from .critic import MLPValueNet
from .policy import make_std_fn


class MLPGaussianPolicy(ActivatedMLP):
    def __init__(self, in_dim: int, action_dim: int, hidden_dims: Sequence[int] = (256, 256), activation: str = "tanh",
                 contextual_std: bool = True, init_std: float = 1.0, minimal_std: float = 1e-5,
                 max_std: Optional[float] = None, device=None):
        super().__init__(in_dim, hidden_dims, activation, device=device)
        self.contextual_std = contextual_std
        self.init_std, self.minimal_std = init_std, minimal_std
        self.std_fn = make_std_fn(init_std, minimal_std, max_std)
        head_init = orthogonal_init(0.01)
        self.mean = Dense(self.out_dim, action_dim, kernel_init=head_init, device=device)
        if contextual_std:
            self.pre_std = Dense(self.out_dim, action_dim, kernel_init=head_init, device=device)
        else:
            self.pre_std = nn.Parameter(torch.zeros(action_dim, device=device))

    def reset_loose_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if not self.contextual_std:
            nn.init.normal_(self.pre_std, 0.0, 0.01, generator=generator)

    def forward(self, graph, obs: torch.Tensor) -> DiagGaussian:
        del graph  # flat family
        h = self.hidden(obs)
        mean = self.mean(h)
        pre = self.pre_std(h) if self.contextual_std else self.pre_std.expand_as(mean)
        return DiagGaussian(mean, self.std_fn(pre))


class MLPCritic(MLPValueNet):
    """Flat-observation value net with the `(graph, obs)` signature."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (256, 256), activation: str = "tanh", device=None):
        super().__init__(in_dim, hidden_dims, activation, device=device)

    def forward(self, graph, obs: torch.Tensor) -> torch.Tensor:
        del graph
        return super().forward(obs)
