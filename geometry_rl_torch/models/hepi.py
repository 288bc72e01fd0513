"""HEPi — heterogeneous E(3)-equivariant PONITA policy network (port of
`geometry_rl_tpu/models/hepi.py`).

`forward(graph, feats) -> (out [B, G, output_dim_vec, 3], latent [B, G,
latent_dim])` with G the number of output nodes (`concat_global` appends the
mean over all nodes, doubling the latent's width). Node signals are lifted onto
an S2 orientation grid; message passing runs per edge LEVEL with the binary
per-round schedule `message_codes`; the decoder gives equivariant vector
outputs as orientation-weighted sums.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..graphs.types import GraphFeatures, HeteroGraph
from ..utils.math import fibonacci_lattice
from .common import Dense, gather_nodes
from .ponita import FiberBundleConv, PolynomialBasis, compute_invariants, scalar_to_sphere, vec_to_sphere


class HEPi(nn.Module):
    def __init__(
        self,
        in_scalars: int,
        in_vectors: int,
        latent_dim: int = 64,
        hidden_dim: int = 64,
        output_dim: int = 1,
        output_dim_vec: int = 1,
        num_ori: int = 16,
        degree: int = 2,
        num_messages: int = 2,
        edge_levels: Sequence[str] = ("internal", "agent", "task"),
        message_codes: Sequence[Sequence[int]] = ((1, 0), (0, 1), (0, 1)),
        only_upper_hemisphere: bool = True,
        graph_levels: Optional[Sequence[str]] = None,
        concat_global: bool = False,
        basis_dim: Optional[int] = None,
        widening_factor: int = 4,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.output_dim, self.num_ori, self.dtype = output_dim, num_ori, dtype
        self.num_messages, self.edge_levels, self.message_codes = num_messages, tuple(edge_levels), message_codes
        self.concat_global = concat_global
        self.register_buffer(
            "ori_grid", fibonacci_lattice(num_ori, upper_hemisphere=only_upper_hemisphere, device=device), persistent=False
        )
        basis_dim = basis_dim or hidden_dim
        self.basis_fn = PolynomialBasis(2, hidden_dim, basis_dim, degree, dtype=dtype, device=device)
        self.fiber_basis_fn = PolynomialBasis(1, hidden_dim, basis_dim, degree, dtype=dtype, device=device)
        self.node_encoder = Dense(in_scalars + in_vectors, latent_dim, bias=False, dtype=dtype, device=device)
        # a conv per (round, level) that the input graphs have edges of
        # (None: every level), as the reference gets params for the convs it calls
        for k in range(num_messages):
            for li, level in enumerate(self.edge_levels):
                if message_codes[li][k] == 1 and (graph_levels is None or level in graph_levels):
                    self.add_module(
                        f"processor_{k}_{level}",
                        FiberBundleConv(latent_dim, basis_dim, widening_factor, dtype=dtype, device=device),
                    )
        self.decoder = Dense(latent_dim * (2 if concat_global else 1), output_dim + output_dim_vec, dtype=dtype, device=device)

    def forward(self, graph: HeteroGraph, feats: GraphFeatures, ori_grid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if ori_grid is None:
            ori_grid = self.ori_grid
        latent: Dict[str, torch.Tensor] = {}
        for nt in graph.node_types:
            scalar = scalar_to_sphere(feats.scalars[nt], ori_grid)  # [B,N,O,S]
            vector = vec_to_sphere(feats.vectors[nt], ori_grid)  # [B,N,O,V]
            latent[nt] = self.node_encoder(torch.cat([scalar, vector], dim=-1))

        # invariants use RAW positions (graph pos), not the normalized ones
        kernel_basis: Dict = {}
        fiber_basis = None
        for ek, es in graph.edges.items():
            src, _, dst = ek
            pos_src = gather_nodes(graph.nodes[src].pos, es.src)
            pos_dst = gather_nodes(graph.nodes[dst].pos, es.dst)
            spatial_inv, ori_inv = compute_invariants(ori_grid, pos_src, pos_dst)
            kernel_basis[ek] = self.basis_fn(spatial_inv)
            if fiber_basis is None:
                fiber_basis = self.fiber_basis_fn(ori_inv)  # [O,O,basis], edge-type independent

        # one conv per (round, level), shared across the level's edge types;
        # several edge types into the same dst SUM their updated dst
        for k in range(self.num_messages):
            out_dst: Dict[str, list] = {}
            for ek, es in graph.edges.items():
                src, level, dst = ek
                if level not in self.edge_levels or self.message_codes[self.edge_levels.index(level)][k] != 1:
                    continue
                conv = getattr(self, f"processor_{k}_{level}")
                updated = conv(latent[src], latent[dst], es.src, es.dst, es.mask, kernel_basis[ek], fiber_basis,
                               es.src_csr, es.dst_csr)
                out_dst.setdefault(dst, []).append(updated)
            for dst, vals in out_dst.items():
                latent[dst] = sum(vals) if len(vals) > 1 else vals[0]

        h = latent[graph.output_node_type]  # [B,G,O,C]
        if self.concat_global:
            # global mean over every node of every type
            g = torch.cat([latent[nt] for nt in graph.node_types], dim=1).mean(dim=1, keepdim=True)
            h = torch.cat([h, g.expand(h.shape[:2] + g.shape[2:])], dim=-1)
        output = self.decoder(h).float()  # decode in f32
        out_scalar = output[..., : self.output_dim].mean(dim=-2)  # [B,G,out_s]
        out_vec_sph = output[..., self.output_dim :]  # [B,G,O,out_v]
        out_vec = torch.einsum("bgov,od->bgvd", out_vec_sph, ori_grid) / self.num_ori  # [B,G,out_v,3]
        out = out_vec * out_scalar[..., None]
        return out, h.float().mean(dim=-2)
