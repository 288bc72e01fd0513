"""Shared NN building blocks (port of `geometry_rl_tpu/models/common.py`).

`Dense` and `LayerNorm` follow Flax's semantics: parameters stay float32 and
activations are computed in the module's `dtype`; Dense kernels start
LeCun-normal (truncated) with zero bias, or orthogonal for output heads;
LayerNorm uses eps 1e-6 and computes its statistics in float32.

Gathers and scatters use `index_select` / `index_add_` over a flattened
(env, node) axis. The reference's one-hot-matmul lowering is a TPU layout
choice and is not carried over.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched node gather: x [B, N, ...], idx [B, E] int -> [B, E, ...]."""
    B, N = x.shape[:2]
    out = x.reshape((B * N,) + x.shape[2:]).index_select(0, _flat_index(idx, N))
    return out.reshape(idx.shape + x.shape[2:])


def scatter_sum(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """Batched scatter-add: messages [B, E, ...], dst [B, E] -> [B, N, ...].
    bf16/f16 messages are summed in f32 and the sum rounded once, as the
    reference's one-hot contraction accumulates."""
    B, E = dst.shape
    tail = messages.shape[2:]
    acc = torch.float32 if messages.dtype in (torch.bfloat16, torch.float16) else messages.dtype
    out = torch.zeros((B * num_nodes,) + tail, dtype=acc, device=messages.device)
    out.index_add_(0, _flat_index(dst, num_nodes), messages.reshape((B * E,) + tail).to(acc))
    return out.reshape((B, num_nodes) + tail).to(messages.dtype)


def scatter_mean(messages: torch.Tensor, dst: torch.Tensor, num_nodes: int, mask: Optional[torch.Tensor] = None):
    if mask is not None:
        messages = messages * mask.reshape(mask.shape + (1,) * (messages.ndim - mask.ndim))
        weights = mask
    else:
        weights = torch.ones(dst.shape, dtype=messages.dtype, device=messages.device)
    total = scatter_sum(messages, dst, num_nodes)
    counts = torch.clamp(scatter_sum(weights, dst, num_nodes), min=1.0)
    return total / counts.reshape(counts.shape + (1,) * (total.ndim - 2))
