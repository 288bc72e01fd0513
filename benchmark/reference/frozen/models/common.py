"""Shared NN building blocks (port of `geometry_rl_tpu/models/common.py`).

`Dense` and `LayerNorm` follow Flax's semantics: parameters stay float32 and
activations are computed in the module's `dtype`; Dense kernels start
LeCun-normal (truncated) with zero bias, or orthogonal for output heads;
LayerNorm uses eps 1e-6 and computes its statistics in float32.

Gathers use `index_select` over a flattened (env, node) axis. Every sum of
graph messages (a scatter, a gather's backward) is `models/segment.py`'s
segment sum in the order of the edge set's CSR: the fixed order that the
reference's one-hot contractions have, without their [E, N] one-hot matrix.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..graphs.types import CSR
from .segment import csr_or_on_the_spot, segment_sum


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Flax's default GELU: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def orthogonal_init(gain: float = 1.0) -> Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]:
    def init(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return nn.init.orthogonal_(weight, gain=gain, generator=generator)

    return init


def lecun_normal(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978  # stddev of N(0,1) truncated at +-2
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


class Dense(nn.Linear):
    """Flax `nn.Dense`: f32 parameters, compute in `dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=torch.float32,
                 kernel_init: Callable = lecun_normal, device=None):
        self.kernel_init = kernel_init
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        with torch.no_grad():
            self.kernel_init(self.weight, generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Flax `nn.LayerNorm`: eps 1e-6, statistics in f32, output in `dtype`."""

    def __init__(self, features: int, dtype=torch.float32, device=None):
        super().__init__(features, eps=1e-6, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Draw fresh parameters for every Dense / LayerNorm in `module`, zero the
    loose biases registered as `bias` parameters (the PONITA convs), and let
    a module that holds other bare parameters (a layer scale, a CLS token, a
    non-contextual `pre_std`) draw them in its `reset_loose_parameters`."""
    for m in module.modules():
        if isinstance(m, Dense):
            m.reset_parameters(generator)
        elif isinstance(m, LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(getattr(m, "bias", None), nn.Parameter) and not isinstance(m, nn.Linear):
            nn.init.zeros_(m.bias)
        if hasattr(m, "reset_loose_parameters"):
            m.reset_loose_parameters(generator)


ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "elu": F.elu, "gelu": gelu, "silu": F.silu}


class MLP(nn.Module):
    """Plain MLP: `features` are the hidden+output sizes; optional LayerNorm
    after hidden layers (norm applies to hidden layers, not the output).
    Submodules are named as Flax names them (dense_i, layer_norm_i)."""

    def __init__(self, in_features: int, features: Sequence[int], activation: Callable = gelu,
                 layer_norm: bool = False, final_activation: bool = False, device=None):
        super().__init__()
        self.activation = activation
        self.n = len(features)
        self.final_activation = final_activation
        self.layer_norm = layer_norm
        dims = [in_features, *features]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"dense_{i}", Dense(a, b, device=device))
            if layer_norm and (i < self.n - 1 or final_activation):
                self.add_module(f"layer_norm_{i}", LayerNorm(b, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"dense_{i}")(x)
            if i < self.n - 1 or self.final_activation:
                if self.layer_norm:
                    x = getattr(self, f"layer_norm_{i}")(x)
                x = self.activation(x)
        return x


class ActivatedMLP(nn.Module):
    """The flat-observation agents' trunk: `dense_i` + a named activation per
    hidden width (f32). `hidden(obs)` -> [..., hidden_dims[-1]] (`out_dim`)."""

    def __init__(self, in_dim: int, hidden_dims: Sequence[int], activation: str, device=None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.n_hidden = len(hidden_dims)
        dims = [in_dim, *hidden_dims]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"dense_{i}", Dense(a, b, device=device))
        self.out_dim = dims[-1]

    def hidden(self, obs: torch.Tensor) -> torch.Tensor:
        h = obs
        for i in range(self.n_hidden):
            h = self.act(getattr(self, f"dense_{i}")(h))
        return h


def _flat_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[B, E] per-env indices -> [B*E] indices into a flattened [B*n] axis."""
    offs = torch.arange(idx.shape[0], device=idx.device)[:, None] * n
    return (idx + offs).reshape(-1)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, N, ...], idx [B, E] -> [B, E, ...] (a gather: no sum)."""
    B, N = x.shape[:2]
    out = x.reshape((B * N,) + x.shape[2:]).index_select(0, _flat_index(idx, N))
    return out.reshape(idx.shape + x.shape[2:])


def _segment_sum(values: torch.Tensor, idx: torch.Tensor, n: int, csr: Optional[CSR]) -> torch.Tensor:
    """values [B, E, ...] summed by idx [B, E] into [B, n, ...] in the CSR's order."""
    B, E = idx.shape
    tail = values.shape[2:]
    out = segment_sum(values.reshape(B, E, -1), csr_or_on_the_spot(csr, idx, n))
    return out.reshape((B, n) + tail)


class _GatherNodes(torch.autograd.Function):
    """Forward a gather; backward the segment sum of the gradient over the
    CSR of the gather's index (made on the spot if the caller has none)."""

    @staticmethod
    def forward(ctx, x, idx, csr):
        ctx.save_for_backward(idx)
        ctx.num_nodes, ctx.csr = x.shape[1], csr
        return _take(x, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return _segment_sum(grad, idx, ctx.num_nodes, ctx.csr), None, None


class _ScatterSum(torch.autograd.Function):
    """Forward the segment sum over the CSR of `dst`; backward a gather of
    the gradient by `dst`."""

    @staticmethod
    def forward(ctx, messages, dst, num_nodes, csr):
        ctx.save_for_backward(dst)
        return _segment_sum(messages, dst, num_nodes, csr)

    @staticmethod
    def backward(ctx, grad):
        (dst,) = ctx.saved_tensors
        return _take(grad, dst), None, None, None


def gather_nodes(x: torch.Tensor, idx: torch.Tensor, csr: Optional[CSR] = None) -> torch.Tensor:
    """Batched node gather: x [B, N, ...], idx [B, E] int -> [B, E, ...].
    `csr` (of idx into N nodes) orders the backward's sum. Without a
    gradient to take (the collect, node positions) the autograd function's
    host time is skipped: the forward is the same gather."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherNodes.apply(x, idx, csr)
    return _take(x, idx)


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int, csr: Optional[CSR] = None) -> torch.Tensor:
    """Batched scatter-add: messages [B, E, ...], dst [B, E] -> [B, N, ...],
    summed in the order of `csr` (of dst into N nodes). bf16/f16 messages are
    summed in f32 and the sum rounded once, as the reference's one-hot
    contraction accumulates."""
    if torch.is_grad_enabled() and messages.requires_grad:
        return _ScatterSum.apply(messages, dst, num_nodes, csr)
    return _segment_sum(messages, dst, num_nodes, csr)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int, mask: Optional[torch.Tensor] = None,
                 csr: Optional[CSR] = None):
    if mask is not None:
        messages = messages * mask.reshape(mask.shape + (1,) * (messages.ndim - mask.ndim))
        weights = mask
    else:
        weights = torch.ones(dst.shape, dtype=messages.dtype, device=messages.device)
    total = scatter_sum(messages, dst, num_nodes, csr)
    counts = torch.clamp(scatter_sum(weights, dst, num_nodes, csr), min=1.0)
    return total / counts.reshape(counts.shape + (1,) * (total.ndim - 2))
