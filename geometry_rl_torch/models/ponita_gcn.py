"""PonitaGCN ("EMPN"): homogeneous PONITA over the merged graph (port of
`geometry_rl_tpu/models/ponita_gcn.py`).

The hetero graph is homogenized (node types concatenated in `graph.nodes`
order, edges offset) and a stack of SeparableFiberBundleConvNext layers runs
over all nodes; the readout happens at the output node slice. `forward(graph,
feats) -> (out [B, G, output_dim_vec, 3], hidden [B, G, hidden_dim])`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..graphs.homogenize import homogenize
from ..graphs.types import GraphFeatures, HeteroGraph
from ..utils.math import fibonacci_lattice
from .common import Dense, gather_nodes
from .ponita import (
    PolynomialBasis,
    SeparableFiberBundleConvNext,
    compute_invariants,
    scalar_to_sphere,
    sphere_to_scalar,
    sphere_to_vec,
    vec_to_sphere,
)


class PonitaGCN(nn.Module):
    def __init__(
        self,
        in_scalars: int,
        in_vectors: int,
        latent_dim: int = 64,  # kept for the reference's signature; the width is `hidden_dim`
        hidden_dim: int = 64,
        output_dim: int = 1,
        output_dim_vec: int = 1,
        num_layers: int = 2,
        num_ori: int = 16,
        degree: int = 2,
        widening_factor: int = 4,
        only_upper_hemisphere: bool = True,
        dtype=torch.float32,
        device=None,
    ):
        super().__init__()
        self.output_dim, self.num_layers, self.num_ori, self.dtype = output_dim, num_layers, num_ori, dtype
        self.register_buffer(
            "ori_grid", fibonacci_lattice(num_ori, upper_hemisphere=only_upper_hemisphere, device=device), persistent=False
        )
        kw = dict(dtype=dtype, device=device)
        self.x_embedder = Dense(in_scalars + in_vectors, hidden_dim, bias=False, **kw)
        self.basis_fn = PolynomialBasis(2, hidden_dim, hidden_dim, degree, **kw)
        self.fiber_basis_fn = PolynomialBasis(1, hidden_dim, hidden_dim, degree, **kw)
        for i in range(num_layers):
            self.add_module(
                f"interaction_{i}",
                SeparableFiberBundleConvNext(hidden_dim, hidden_dim, widening_factor, layer_scale_init=None, **kw),
            )
        self.readout = Dense(hidden_dim, output_dim + output_dim_vec, **kw)

    def forward(self, graph: HeteroGraph, feats: GraphFeatures, ori_grid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        if ori_grid is None:
            ori_grid = self.ori_grid
        homo = homogenize(graph, with_csr=True)

        # merged sphere-lifted inputs
        xs = []
        for nt in graph.nodes.keys():
            scalar = scalar_to_sphere(feats.scalars[nt], ori_grid)
            vector = vec_to_sphere(feats.vectors[nt], ori_grid)
            xs.append(torch.cat([scalar, vector], dim=-1))
        x = self.x_embedder(torch.cat(xs, dim=1))  # [B,Ntot,O,C]

        pos_src = gather_nodes(homo.pos, homo.edges.src)
        pos_dst = gather_nodes(homo.pos, homo.edges.dst)
        spatial_inv, ori_inv = compute_invariants(ori_grid, pos_src, pos_dst)
        kernel_basis = self.basis_fn(spatial_inv)
        fiber_basis = self.fiber_basis_fn(ori_inv)

        for i in range(self.num_layers):
            x = getattr(self, f"interaction_{i}")(x, homo.edges.src, homo.edges.dst, homo.edges.mask, kernel_basis, fiber_basis,
                                                   homo.edges.src_csr, homo.edges.dst_csr)

        # read out in f32 at the output node slice (the readout is per node,
        # so slicing first gives the same values as slicing after)
        start, stop = homo.output_slice(graph)
        x = x[:, start:stop]
        output = self.readout(x).float()
        out_scalar = sphere_to_scalar(output[..., : self.output_dim])  # [B,G,out_s]
        out_vec = sphere_to_vec(output[..., self.output_dim :], ori_grid)  # [B,G,out_v,3]
        return out_vec * out_scalar[..., None], sphere_to_scalar(x.float())
