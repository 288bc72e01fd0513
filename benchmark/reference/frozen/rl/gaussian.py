"""Diagonal-Gaussian distributions (port of `geometry_rl_tpu/rl/gaussian.py`):
`(mean [..., K], std [..., K])` vectors, with the (mean part, cov part)
decompositions of the KL, Frobenius and commutative W2 divergences."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


LOG_2PI = math.log(2.0 * math.pi)


class DiagGaussian(NamedTuple):
    """A batch of diagonal Gaussians: mean [..., K], std [..., K] (std > 0)."""

    mean: torch.Tensor
    std: torch.Tensor


def log_determinant(std: torch.Tensor) -> torch.Tensor:
    """log det of the covariance (= 2 * sum log std)."""
    return 2.0 * torch.log(std).sum(-1)


def maha(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """Mahalanobis distance ||x - mean||^2 for diag Sigma = std^2."""
    diff = (x - mean) / std
    return (diff * diff).sum(-1)


def log_prob(p: DiagGaussian, x: torch.Tensor) -> torch.Tensor:
    k = x.shape[-1]
    return -0.5 * (maha(x, p.mean, p.std) + k * LOG_2PI + log_determinant(p.std))


def entropy(p: DiagGaussian) -> torch.Tensor:
    k = p.std.shape[-1]
    return 0.5 * (k * (LOG_2PI + 1.0) + log_determinant(p.std))


def sample(generator: torch.Generator, p: DiagGaussian, shape: tuple = ()) -> torch.Tensor:
    """A draw from p."""
    eps = torch.randn(tuple(shape) + p.mean.shape, generator=generator, dtype=p.mean.dtype, device=p.mean.device)
    return p.mean + eps * p.std


def kl_parts(p: DiagGaussian, q: DiagGaussian) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean part, cov part) of KL(p || q): mean part = 0.5 * maha(mu_p, mu_q,
    sigma_q); cov part = 0.5 * (trace + logdet_q - logdet_p - k)."""
    k = p.mean.shape[-1]
    maha_part = 0.5 * maha(p.mean, q.mean, q.std)
    ratio = (p.std / q.std) ** 2
    cov_part = 0.5 * (ratio.sum(-1) - k + log_determinant(q.std) - log_determinant(p.std))
    return maha_part, cov_part


def kl(p: DiagGaussian, q: DiagGaussian) -> torch.Tensor:
    m, c = kl_parts(p, q)
    return m + c


def frobenius_parts(p: DiagGaussian, q: DiagGaussian, scale_prec: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean part, cov part) of the Frobenius divergence: the mean part is
    the Mahalanobis distance under q's covariance with `scale_prec`, else the
    squared Euclidean one; the cov part is ||cov_q - cov_p||_F^2."""
    if scale_prec:
        mean_part = maha(p.mean, q.mean, q.std)
    else:
        mean_part = ((q.mean - p.mean) ** 2).sum(-1)
    diff = q.std**2 - p.std**2
    return mean_part, (diff * diff).sum(-1)


def wasserstein_parts(p: DiagGaussian, q: DiagGaussian, scale_prec: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mean part, cov part) of the commutative W2 divergence (diagonal
    covariances: the matrix square root is the std)."""
    if scale_prec:
        mean_part = maha(p.mean, q.mean, q.std)
        c = (p.std / q.std) ** 2
        cov_part = (1.0 + c - 2.0 * (p.std / q.std)).sum(-1)
    else:
        mean_part = ((q.mean - p.mean) ** 2).sum(-1)
        cov_part = (q.std**2 + p.std**2 - 2.0 * q.std * p.std).sum(-1)
    return mean_part, cov_part
