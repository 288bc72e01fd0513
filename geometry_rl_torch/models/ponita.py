"""PONITA building blocks (port of `geometry_rl_tpu/models/ponita.py`).

Node signals live on a fixed S2 orientation grid [O, 3]; spatial message
passing is gather -> elementwise kernel -> scatter-add, and the fiber
convolution is a dense contraction over orientations. Tensors are padded
per-env dense arrays [B, N, O, C].
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn

from ..utils.trace import spanned
from .common import Dense, LayerNorm, gather_nodes, gelu, scatter_sum


def scalar_to_sphere(scalar: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """[..., S] -> [..., O, S]: broadcast scalar channels over orientations."""
    return scalar[..., None, :].expand(scalar.shape[:-1] + (ori_grid.shape[0], scalar.shape[-1]))


def vec_to_sphere(vec: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """[..., V, D] -> [..., O, V]: project each vector channel onto each
    orientation."""
    return torch.einsum("...vd,od->...ov", vec, ori_grid)


def sphere_to_scalar(x: torch.Tensor) -> torch.Tensor:
    """[..., O, S] -> [..., S]: mean over orientations."""
    return x.mean(dim=-2)


def sphere_to_vec(x: torch.Tensor, ori_grid: torch.Tensor) -> torch.Tensor:
    """[..., O, V] -> [..., V, D]: signal-weighted sum of grid directions."""
    return torch.einsum("...ov,od->...vd", x, ori_grid) / ori_grid.shape[0]


def polynomial_features(x: torch.Tensor, degree: int) -> torch.Tensor:
    """All monomials of x up to `degree`+1 via iterated outer products.
    [..., d] -> [..., sum_{i=1..degree+1} d^i]."""
    feats = [x]
    for _ in range(degree):
        outer = feats[-1][..., :, None] * x[..., None, :]
        feats.append(outer.reshape(outer.shape[:-2] + (-1,)))
    return torch.cat(feats, dim=-1)


def polynomial_dim(d: int, degree: int) -> int:
    return sum(d ** (i + 1) for i in range(degree + 1))


def compute_invariants(ori_grid: torch.Tensor, pos_src: torch.Tensor, pos_dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pairwise position-orientation invariants.

    pos_src/pos_dst: [..., E, 3]. Returns (spatial [..., E, O, 2],
    orientation [O, O, 1])."""
    rel_pos = (pos_src - pos_dst)[..., None, :]  # [..., E, 1, 3]
    ori_a = ori_grid[None, :, :]  # [1, O, 3]
    inv1 = (rel_pos * ori_a).sum(-1, keepdim=True)  # along-ori displacement
    inv2 = torch.linalg.vector_norm(rel_pos - inv1 * ori_a, dim=-1, keepdim=True)  # orthogonal
    spatial = torch.cat([inv1, inv2], dim=-1)
    ori_inv = (ori_grid[None, :, :] * ori_grid[:, None, :]).sum(-1, keepdim=True)
    return spatial, ori_inv


class PolynomialBasis(nn.Module):
    """PolynomialFeatures -> Dense -> GELU -> Dense -> GELU."""

    def __init__(self, in_dim: int, hidden_dim: int, basis_dim: int, degree: int = 2, dtype=torch.float32, device=None):
        super().__init__()
        self.degree = degree
        self.dtype = dtype
        self.dense_0 = Dense(polynomial_dim(in_dim, degree), hidden_dim, dtype=dtype, device=device)
        self.dense_1 = Dense(hidden_dim, basis_dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = polynomial_features(x.to(self.dtype), self.degree)
        return gelu(self.dense_1(gelu(self.dense_0(x))))


def _spatial_conv(x_src, src, dst, edge_mask, num_dst: int, kernel, dt, src_csr=None, dst_csr=None) -> torch.Tensor:
    """Messages kernel_e * x_src[src_e], masked, scatter-added at dst: [B,Nd,O,C].
    The CSRs of src and dst (`EdgeSet.src_csr` / `dst_csr`) order the sums."""
    messages = kernel * gather_nodes(x_src, src, src_csr) * edge_mask[..., None, None].to(dt)  # [B,E,O,C]
    return scatter_sum(messages, dst, num_dst, dst_csr)


def _depthwise_fiber_conv(x_1: torch.Tensor, fiber_kernel: torch.Tensor) -> torch.Tensor:
    """The contraction over orientations, channel by channel, over O."""
    return torch.einsum("bnoc,opc->bnpc", x_1, fiber_kernel) / fiber_kernel.shape[-2]


def _std(t: torch.Tensor) -> torch.Tensor:
    """`jnp.std`: no Bessel correction."""
    return t.float().std(correction=0)


class FiberBundleConv(nn.Module):
    """Separable group conv on the position-orientation fiber bundle.

    forward(x_src [B,Ns,O,C], x_dst [B,Nd,O,C], src, dst, edge_mask,
    kernel_basis [B,E,O,A], fiber_basis [O,O,A]) -> updated dst [B,Nd,O,C]:
      1. spatial conv: m_e = kernel(basis_e) * x_src[src_e]; x1 = scatter-add
      2. fiber conv:   x2 = einsum(x1, fiber_kernel) / O
      3. ConvNeXt update: dst + MLP(LN(x2 + bias))

    `depthwise=True` (groups == channels) is what HEPi instantiates;
    `depthwise=False` mixes all channels in the fiber conv. While
    `calib_stats` is a list, each call appends (std_in, std_1, std_2) for
    `models/calibration.calibrate`.
    """

    def __init__(self, channels: int, basis_dim: int, widening_factor: int = 4, use_bias: bool = True,
                 depthwise: bool = True, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype, self.channels, self.depthwise = dtype, channels, depthwise
        self.kernel = Dense(basis_dim, channels, bias=False, dtype=dtype, device=device)
        self.fiber_kernel = Dense(basis_dim, channels if depthwise else channels * channels, bias=False, dtype=dtype,
                                  device=device)
        self.register_parameter("bias", nn.Parameter(torch.zeros(channels, device=device)) if use_bias else None)
        self.layer_norm_0 = LayerNorm(channels, dtype=dtype, device=device)
        self.dense_0 = Dense(channels, channels * widening_factor, dtype=dtype, device=device)
        self.dense_1 = Dense(channels * widening_factor, channels, dtype=dtype, device=device)
        self.calib_stats: Optional[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None

    def forward(self, x_src, x_dst, src, dst, edge_mask, kernel_basis, fiber_basis, src_csr=None, dst_csr=None):
        dt = self.dtype
        x_src, x_dst = x_src.to(dt), x_dst.to(dt)
        x_1 = _spatial_conv(x_src, src, dst, edge_mask, x_dst.shape[1], self.kernel(kernel_basis), dt, src_csr, dst_csr)
        fiber_kernel = self.fiber_kernel(fiber_basis)  # [O,O,C], or [O,O,C*C]
        if self.depthwise:
            x_2 = _depthwise_fiber_conv(x_1, fiber_kernel)
        else:
            fk = fiber_kernel.reshape(fiber_kernel.shape[:-1] + (self.channels, self.channels))  # [O,P,out,in]
            x_2 = torch.einsum("bnoc,opdc->bnpd", x_1, fk) / fk.shape[0]

        if self.calib_stats is not None:
            self.calib_stats.append((_std(x_dst), _std(x_1), _std(x_2)))

        if self.bias is not None:
            x_2 = x_2 + self.bias.to(dt)
        h = self.dense_1(gelu(self.dense_0(self.layer_norm_0(x_2))))
        return x_dst + h


class SeparableFiberBundleConvNext(nn.Module):
    """Homogeneous-graph ConvNeXt block used by PonitaGCN: conv -> LayerNorm
    -> widening MLP -> layer scale -> residual. `layer_scale_init=None` leaves
    the layer scale (param `layer_scale`) out, as PonitaGCN does."""

    def __init__(self, channels: int, basis_dim: int, widening_factor: int = 4,
                 layer_scale_init: Optional[float] = 1e-6, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.layer_scale_init = layer_scale_init
        self.kernel = Dense(basis_dim, channels, bias=False, dtype=dtype, device=device)
        self.fiber_kernel = Dense(basis_dim, channels, bias=False, dtype=dtype, device=device)
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.layer_norm_0 = LayerNorm(channels, dtype=dtype, device=device)
        self.dense_0 = Dense(channels, channels * widening_factor, dtype=dtype, device=device)
        self.dense_1 = Dense(channels * widening_factor, channels, dtype=dtype, device=device)
        if layer_scale_init is not None:
            self.layer_scale = nn.Parameter(torch.full((channels,), float(layer_scale_init), device=device))
        self.calib_stats: Optional[List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]] = None

    def reset_loose_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        if self.layer_scale_init is not None:
            nn.init.constant_(self.layer_scale, self.layer_scale_init)

    @spanned("models.conv_next")
    def forward(self, x, src, dst, edge_mask, kernel_basis, fiber_basis, src_csr=None, dst_csr=None):
        dt = self.dtype
        x = x.to(dt)
        x_1 = _spatial_conv(x, src, dst, edge_mask, x.shape[1], self.kernel(kernel_basis), dt, src_csr, dst_csr)
        x_2 = _depthwise_fiber_conv(x_1, self.fiber_kernel(fiber_basis))
        if self.calib_stats is not None:
            self.calib_stats.append((_std(x), _std(x_1), _std(x_2)))
        h = self.layer_norm_0(x_2 + self.bias.to(dt))
        h = self.dense_1(gelu(self.dense_0(h)))
        if self.layer_scale_init is not None:
            h = self.layer_scale.to(dt) * h
        return x + h
