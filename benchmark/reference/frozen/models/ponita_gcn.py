"""PonitaGCN ("EMPN"), the paper's equivariant baseline: PONITA run over the
homogenized graph (frozen copy, plain PyTorch).

The hetero graph is merged (node types concatenated in `graph.nodes` order,
edge indices offset; `graphs/homogenize.py`), the node signals are lifted
onto the orientation grid and embedded, and `num_layers`
SeparableFiberBundleConvNext blocks run over every node and every edge of
the merged graph. The readout gives equivariant vectors at the output node
type. `forward(graph, feats) -> (out [B, G, output_dim_vec, 3], hidden [B,
G, hidden_dim])`.

It follows PONITA as the JAX package has it (`geometry_rl_tpu/models/
ponita_gcn.py`), with these departures:
- the message sums add each node's edges in a fixed order, in f32, rounded
  once to the activations' type (`segment.py`): the order of the CSRs of
  the merged src and dst indices, made here on the spot by a stable sort
  (`csr_or_on_the_spot`), which is the order of the merged CSRs a graph
  builder makes once; the JAX package sums by one-hot contractions;
- the readout's Dense runs only at the output node slice: it is per node,
  so slicing first gives the same values;
- the orientation grid is a buffer made at construction, not in the call.

Precision is the configuration's: activations in its `dtype` (bfloat16 in
the benchmark's configurations), parameters in float32, the readout in
float32. The harness turns TF32 off. The control (`reference.build(...,
precision="control")`) rounds each Dense input to float8 e4m3, one step
below the stated bfloat16.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..graphs.homogenize import homogenize
from ..graphs.types import GraphFeatures, HeteroGraph, csr_or_on_the_spot
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
        latent_dim: int = 64,  # in the builders' call; the width is `hidden_dim`
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
        homo = homogenize(graph)
        n = homo.pos.shape[1]
        src, dst = homo.edges.src, homo.edges.dst
        src_csr, dst_csr = csr_or_on_the_spot(None, src, n), csr_or_on_the_spot(None, dst, n)

        xs = []
        for nt in graph.nodes.keys():
            scalar = scalar_to_sphere(feats.scalars[nt], ori_grid)
            vector = vec_to_sphere(feats.vectors[nt], ori_grid)
            xs.append(torch.cat([scalar, vector], dim=-1))
        x = self.x_embedder(torch.cat(xs, dim=1))  # [B, Ntot, O, C]

        spatial_inv, ori_inv = compute_invariants(ori_grid, gather_nodes(homo.pos, src), gather_nodes(homo.pos, dst))
        kernel_basis = self.basis_fn(spatial_inv)
        fiber_basis = self.fiber_basis_fn(ori_inv)
        for i in range(self.num_layers):
            x = getattr(self, f"interaction_{i}")(x, src, dst, homo.edges.mask, kernel_basis, fiber_basis, src_csr, dst_csr)

        start, stop = homo.output_slice(graph)
        x = x[:, start:stop]
        output = self.readout(x).float()
        out_scalar = sphere_to_scalar(output[..., : self.output_dim])  # [B, G, out_s]
        out_vec = sphere_to_vec(output[..., self.output_dim :], ori_grid)  # [B, G, out_v, 3]
        return out_vec * out_scalar[..., None], sphere_to_scalar(x.float())


MODELS = {"empn": PonitaGCN, "ponita_gcn": PonitaGCN}
