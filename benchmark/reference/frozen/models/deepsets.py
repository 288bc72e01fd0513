"""DeepSets — the critic backbone of every reference config (port of
`geometry_rl_tpu/models/deepsets.py`): inner MLP per node (all node types
concatenated, padded nodes masked out of the sum), sum pooling, outer MLP."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import Dense, LayerNorm


class DeepSets(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int = 64, output_dim: int = 64, layer_norm: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.dense_0 = Dense(in_dim, hidden_dim, **kw)
        self.dense_1 = Dense(hidden_dim, hidden_dim, **kw)
        self.dense_2 = Dense(hidden_dim, hidden_dim, **kw)
        self.dense_3 = Dense(hidden_dim, output_dim, **kw)
        if layer_norm:
            self.layer_norm_0 = LayerNorm(hidden_dim, **kw)
            self.layer_norm_1 = LayerNorm(hidden_dim, **kw)
        self.layer_norm = layer_norm

    def forward(self, graph: HeteroGraph, feats: GraphFeatures) -> torch.Tensor:
        homo = homogenize(graph)
        x = self.dense_0(concat_features(graph, feats))  # [B,Ntot,H]
        if self.layer_norm:
            x = self.layer_norm_0(x)
        x = self.dense_1(F.relu(x))
        x = (x * homo.node_mask[..., None].to(self.dtype)).sum(dim=1)  # masked sum pool
        x = self.dense_2(x)
        if self.layer_norm:
            x = self.layer_norm_1(x)
        return self.dense_3(F.relu(x)).float()
