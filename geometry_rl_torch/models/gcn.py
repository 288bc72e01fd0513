"""GCN baseline: edge-attr-weighted message passing over the merged graph
(port of `geometry_rl_tpu/models/gcn.py`).

message = x_src * edge_attr (elementwise, both hidden-dim), scatter-sum, node
update x + MLP([x, agg]). Edge attrs = [edge-type one-hot | relative
displacement | distance], computed from positions.
`forward(graph, feats) -> (out [B, G, output_dim], h [B, G, hidden_dim or 2x])`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.homogenize import HomogeneousGraph, concat_features, homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from .common import Dense, LayerNorm, gather_nodes, scatter_sum


def edge_attributes(homo: HomogeneousGraph) -> torch.Tensor:
    """[B, Etot, num_edge_types + 4]: one-hot type | cartesian | distance."""
    cart = gather_nodes(homo.pos, homo.edges.src) - gather_nodes(homo.pos, homo.edges.dst)
    dist = torch.linalg.vector_norm(cart, dim=-1, keepdim=True)
    return torch.cat([homo.edge_type_onehot, cart, dist], dim=-1)


class ProcessorLayer(nn.Module):
    """Node update without an edge update (the GCN configuration)."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        self.dense_0 = Dense(2 * channels, channels, **kw)
        self.dense_1 = Dense(channels, channels, **kw)
        self.layer_norm_0 = LayerNorm(channels, **kw)

    def forward(self, x, src, dst, edge_mask, edge_attr, src_csr=None, dst_csr=None):
        x = x.to(self.dtype)
        messages = gather_nodes(x, src, src_csr) * edge_attr * edge_mask[..., None].to(self.dtype)
        agg = scatter_sum(messages, dst, x.shape[1], dst_csr)
        h = self.dense_1(F.relu(self.dense_0(torch.cat([x, agg], dim=-1))))
        return x + self.layer_norm_0(h)


class GCN(nn.Module):
    def __init__(self, in_dim: int, num_edge_types: int, hidden_dim: int = 64, output_dim: int = 6, num_layers: int = 2,
                 concat_global: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.num_layers, self.concat_global, self.dtype = num_layers, concat_global, dtype
        kw = dict(dtype=dtype, device=device)
        self.node_lin = Dense(in_dim, hidden_dim, **kw)
        self.dense_0 = Dense(num_edge_types + 4, hidden_dim, **kw)
        self.dense_1 = Dense(hidden_dim, hidden_dim, **kw)
        self.dense_2 = Dense(hidden_dim, hidden_dim, **kw)
        self.layer_norm_0 = LayerNorm(hidden_dim, **kw)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", ProcessorLayer(hidden_dim, **kw))
        self.mlp = Dense(hidden_dim * (2 if concat_global else 1), output_dim, device=device)  # f32

    def forward(self, graph: HeteroGraph, feats: GraphFeatures) -> Tuple[torch.Tensor, torch.Tensor]:
        homo = homogenize(graph, with_csr=True)
        x = self.node_lin(concat_features(graph, feats))
        e = self.dense_2(F.relu(self.dense_1(F.relu(self.dense_0(edge_attributes(homo))))))
        e = self.layer_norm_0(e)
        for i in range(self.num_layers):
            x = getattr(self, f"conv_{i}")(x, homo.edges.src, homo.edges.dst, homo.edges.mask, e,
                                           homo.edges.src_csr, homo.edges.dst_csr)
        x = x.float()

        start, stop = homo.output_slice(graph)
        h = x[:, start:stop]
        if self.concat_global:
            # global max pool over real nodes
            masked = torch.where(homo.node_mask[..., None] > 0.5, x, torch.finfo(x.dtype).min)
            g = masked.max(dim=1, keepdim=True).values
            h = torch.cat([g.expand_as(h), h], dim=-1)
        return self.mlp(h), h
