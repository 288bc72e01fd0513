"""MeshGraphNet-style encode-process-decode GNN (port of
`geometry_rl_tpu/models/meshgraphnet.py`).

Node and edge MLP encoders, N processor layers with residual EDGE updates
(e' = e + MLP([x_dst, x_src, e]); x' = x + MLP([x, sum_in e'])), and a node
decoder read out at the output node slice, on the homogenized graph.
`forward(graph, feats) -> (out [B, G, output_dim], h [B, G, hidden_dim])`.

The reference builds each MLP as `nn.Sequential([Dense, relu, Dense,
LayerNorm])` inside its parent's compact call, so Flax names the layers in
the parent, counted per class in creation order: the first MLP owns
`Dense_0`, `Dense_1`, `LayerNorm_0`, the second `Dense_2`, `Dense_3`,
`LayerNorm_1`. The port's attributes carry the same names.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.homogenize import concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import Dense, LayerNorm, gather_nodes, scatter_sum
from .gcn import edge_attributes


class _TwoMLPs(nn.Module):
    """Two Dense -> ReLU -> Dense -> LayerNorm stacks of width `width`, named
    as Flax names them in one parent."""

    def __init__(self, in_first: int, in_second: int, width: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.dense_0, self.dense_1, self.layer_norm_0 = Dense(in_first, width, **kw), Dense(width, width, **kw), LayerNorm(width, **kw)
        self.dense_2, self.dense_3, self.layer_norm_1 = Dense(in_second, width, **kw), Dense(width, width, **kw), LayerNorm(width, **kw)

    def first(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm_0(self.dense_1(F.relu(self.dense_0(x))))

    def second(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm_1(self.dense_3(F.relu(self.dense_2(x))))


class EdgeProcessorLayer(_TwoMLPs):
    """Processor layer with an edge update (first MLP) and a node update
    (second MLP)."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__(3 * channels, 2 * channels, channels, dtype=dtype, device=device)

    def forward(self, x, e, src, dst, edge_mask, src_csr=None, dst_csr=None):
        e_new = e + self.first(torch.cat([gather_nodes(x, dst, dst_csr), gather_nodes(x, src, src_csr), e], dim=-1))
        agg = scatter_sum(e_new * edge_mask[..., None].to(e_new.dtype), dst, x.shape[1], dst_csr)
        return x + self.second(torch.cat([x, agg], dim=-1)), e_new


class MeshGraphNet(_TwoMLPs):
    """Node encoder (first MLP), edge encoder (second MLP), processors, decoder."""

    def __init__(self, in_dim: int, num_edge_types: int, hidden_dim: int = 64, output_dim: int = 64, num_layers: int = 2,
                 dtype=torch.float32, device=None):
        super().__init__(in_dim, num_edge_types + 4, hidden_dim, dtype=dtype, device=device)
        self.num_layers, self.dtype = num_layers, dtype
        for i in range(num_layers):
            self.add_module(f"processor_{i}", EdgeProcessorLayer(hidden_dim, dtype=dtype, device=device))
        self.decoder = Dense(hidden_dim, output_dim, device=device)  # f32

    def forward(self, graph: HeteroGraph, feats: GraphFeatures) -> Tuple[torch.Tensor, torch.Tensor]:
        homo = homogenize(graph, with_csr=True)
        x = self.first(concat_features(graph, feats).to(self.dtype))
        e = self.second(edge_attributes(homo).to(self.dtype))
        for i in range(self.num_layers):
            x, e = getattr(self, f"processor_{i}")(x, e, homo.edges.src, homo.edges.dst, homo.edges.mask,
                                                  homo.edges.src_csr, homo.edges.dst_csr)
        start, stop = homo.output_slice(graph)
        h = x.float()[:, start:stop]
        return self.decoder(h), h
