"""Tensor utilities (port of `geometry_rl_tpu/utils/tensor.py`): batched
traces, matrix square roots (Denman-Beavers and eigen), triangular packing
for full-covariance policies, inverse softplus, Polyak averaging, one- and
two-hot encodings and shuffled minibatch indices.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Union

import numpy as np
import torch


def batched_trace(x: torch.Tensor) -> torch.Tensor:
    """tr(X) over the last two dims."""
    return torch.diagonal(x, dim1=-2, dim2=-1).sum(-1)


def batched_trace_square(x: torch.Tensor) -> torch.Tensor:
    """tr(X X^T) = the sum of squares of X."""
    return (x * x).sum((-2, -1))


def sqrtm_newton(mat: torch.Tensor, num_iters: int = 20) -> torch.Tensor:
    """Matrix square root of PSD matrices by the Denman-Beavers iteration;
    batched and differentiable."""
    dim = mat.shape[-1]
    norm = torch.linalg.matrix_norm(mat, keepdim=True)  # Frobenius, as jnp.linalg.norm over two axes
    y = mat / norm
    eye = torch.eye(dim, dtype=mat.dtype, device=mat.device).expand(mat.shape)
    z = eye
    for _ in range(num_iters):
        t = 0.5 * (3.0 * eye - z @ y)
        y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def sqrtm_eig(mat: torch.Tensor) -> torch.Tensor:
    """Matrix square root of symmetric PSD matrices by eigendecomposition."""
    w, v = torch.linalg.eigh(mat)
    w = torch.sqrt(torch.clamp(w, min=0.0))
    return (v * w[..., None, :]) @ v.transpose(-2, -1)


def fill_triangular(x: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """A [..., d(d+1)/2] vector packed into a lower (default) or upper
    triangular [..., d, d] matrix, row by row."""
    d = int((math.sqrt(8 * x.shape[-1] + 1) - 1) / 2)
    rows, cols = np.tril_indices(d)
    out = x.new_zeros(x.shape[:-1] + (d, d))
    out[..., rows, cols] = x
    return out.transpose(-2, -1) if upper else out


def fill_triangular_inverse(mat: torch.Tensor, upper: bool = False) -> torch.Tensor:
    """The packed vector of a triangular matrix (`fill_triangular`'s inverse)."""
    if upper:
        mat = mat.transpose(-2, -1)
    rows, cols = np.tril_indices(mat.shape[-1])
    return mat[..., rows, cols]


def inverse_softplus(x) -> torch.Tensor:
    """softplus^-1, x itself from 20 on (where softplus(x) == x in f32)."""
    x = torch.as_tensor(x)
    return torch.where(x < 20.0, torch.log(torch.expm1(torch.clamp(x, max=20.0))), x)


def polyak_update(target: Union[torch.nn.Module, Dict[str, torch.Tensor]], online: Union[torch.nn.Module, Dict[str, torch.Tensor]],
                  tau: float):
    """target <- (1 - tau) * target + tau * online. Modules are updated in
    place through their `state_dict` (floating entries only) and returned;
    dicts of tensors give a new dict."""
    if isinstance(target, torch.nn.Module):
        src = online.state_dict() if isinstance(online, torch.nn.Module) else online
        with torch.no_grad():
            for k, t in target.state_dict().items():
                if t.is_floating_point():
                    t.copy_((1.0 - tau) * t + tau * src[k])
        return target
    return {k: (1.0 - tau) * t + tau * online[k] for k, t in target.items()}


def one_hot(idx: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot rows (jax.nn.one_hot's dtype)."""
    return torch.nn.functional.one_hot(idx.long(), num_classes).to(torch.float32)


def two_hot(x: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Scalars encoded onto a bin grid, their mass split linearly between the
    two neighbouring bins."""
    x = torch.clamp(x, bins[0], bins[-1])
    upper_idx = torch.clamp(torch.searchsorted(bins, x, side="left"), 1, len(bins) - 1)
    lower_idx = upper_idx - 1
    lower, upper = bins[lower_idx], bins[upper_idx]
    w_upper = (x - lower) / torch.clamp(upper - lower, min=1e-8)
    out = torch.zeros(x.shape + (len(bins),), dtype=torch.float32, device=x.device)
    out.scatter_add_(-1, lower_idx[..., None], (1.0 - w_upper)[..., None].to(out.dtype))
    out.scatter_add_(-1, upper_idx[..., None], w_upper[..., None].to(out.dtype))
    return out


def generate_minibatches(generator: torch.Generator, n: int, batch_size: int) -> Iterator[torch.Tensor]:
    """Shuffled minibatch index tensors of `batch_size` (a permutation of n
    drawn from `generator`; a last, short batch is dropped)."""
    perm = torch.randperm(n, generator=generator, device=generator.device)
    for start in range(0, n - batch_size + 1, batch_size):
        yield perm[start : start + batch_size]
