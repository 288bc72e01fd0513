"""Value networks (port of `geometry_rl_tpu/models/critic.py`): the graph
critic (backbone latent -> Linear -> scalar; an `(out, latent)` backbone's
latent is mean-pooled over its output nodes) and a flat-observation MLP critic."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..graphs.types import GraphFeatures, HeteroGraph
from .common import ActivatedMLP, Dense, orthogonal_init


class GraphValueNet(nn.Module):
    def __init__(self, backbone: nn.Module, latent_dim: int, device=None):
        super().__init__()
        self.backbone = backbone
        self.final = Dense(latent_dim, 1, kernel_init=orthogonal_init(0.01), device=device)

    def forward(self, graph: HeteroGraph, feats: GraphFeatures) -> torch.Tensor:
        h = self.backbone(graph, feats)
        if isinstance(h, tuple):  # (out, latent) backbones: pool the latent
            h = h[1].mean(dim=1)
        return self.final(h).squeeze(-1)  # [B]


class MLPValueNet(ActivatedMLP):
    """Flat-observation MLP critic: `forward(obs [B, D]) -> [B]`."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int] = (64, 64), activation: str = "elu", device=None):
        super().__init__(in_dim, hidden_dims, activation, device=device)
        self.final = Dense(self.out_dim, 1, kernel_init=orthogonal_init(0.01), device=device)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return self.final(self.hidden(obs)).squeeze(-1)
