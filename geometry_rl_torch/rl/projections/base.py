"""Trust-region projection layers for diagonal Gaussians (port of
`geometry_rl_tpu/rl/projections/base.py`): the identity, KL, Frobenius and
W2 layers and the factory (PAPI's layer is in `papi.py`).

A layer is a frozen dataclass whose `__call__(p, q, step, initial_entropy)`
returns the projected distribution, with the optional entropy projection
before or after the trust-region projection.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ...parallel.mesh import batch_mean
from ...utils.trace import spanned
from ..gaussian import DiagGaussian, entropy, frobenius_parts, kl_parts, wasserstein_parts
from .kl import kl_diag_cov_projection


def mean_projection(mean: torch.Tensor, old_mean: torch.Tensor, maha_part: torch.Tensor, eps) -> torch.Tensor:
    """Closed-form mean projection onto the Mahalanobis ball: interpolate
    toward old_mean with omega = sqrt(maha/eps) - 1 where maha > eps."""
    mask = maha_part > eps
    omega = torch.sqrt(torch.clamp(maha_part, min=1e-16) / eps) - 1.0
    omega = torch.abs(omega)[..., None]
    m = (mean + omega * old_mean) / (1.0 + omega + 1e-16)
    return torch.where(mask[..., None], m, mean)


def entropy_inequality_projection(p: DiagGaussian, beta) -> DiagGaussian:
    """Scale std so that entropy >= beta where it is violated."""
    k = p.std.shape[-1]
    ent = entropy(p)
    mask = ent < beta
    alpha = torch.exp((beta - ent) / k)
    return DiagGaussian(p.mean, torch.where(mask[..., None], p.std * alpha[..., None], p.std))


def entropy_equality_projection(p: DiagGaussian, beta) -> DiagGaussian:
    """Scale std so that entropy == beta exactly."""
    k = p.std.shape[-1]
    alpha = torch.exp((beta - entropy(p)) / k)
    return DiagGaussian(p.mean, p.std * alpha[..., None])


def entropy_schedule(schedule: Optional[str], total_train_steps: Optional[int], dim: Optional[int]):
    """Entropy-bound schedule: f(initial_entropy, target_entropy, temperature, step)."""
    if schedule == "linear":
        return lambda e0, et, temp, step: step * (et - e0) / total_train_steps + e0
    if schedule == "exp":
        return lambda e0, et, temp, step: dim * et + (e0 - dim * et) * temp ** (10 * step / total_train_steps)
    return lambda e0, et, temp, step: torch.tensor(-torch.inf)


@dataclasses.dataclass(frozen=True)
class BaseProjection:
    """No-op trust region; subclasses override `_trust_region_projection`."""

    mean_bound: float = 0.03
    cov_bound: float = 1e-3
    trust_region_coeff: float = 1.0
    scale_prec: bool = True
    entropy_schedule_type: Optional[str] = None
    action_dim: Optional[int] = None
    total_train_steps: Optional[int] = None
    target_entropy: float = 0.0
    temperature: float = 0.0
    entropy_eq: bool = False
    entropy_first: bool = False

    @spanned("rl.projection")
    def __call__(self, p: DiagGaussian, q: DiagGaussian, step=0, initial_entropy: Optional[torch.Tensor] = None) -> DiagGaussian:
        beta = self.entropy_bound(step, initial_entropy, p.mean)
        entropy_proj = entropy_equality_projection if self.entropy_eq else entropy_inequality_projection
        if self.entropy_first:
            p = entropy_proj(p, beta)
        proj = self._trust_region_projection(p, q, self.mean_bound, self.cov_bound)
        if self.entropy_first:
            return proj
        return entropy_proj(proj, beta)

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        return p

    # -- metrics & loss ------------------------------------------------------

    def trust_region_value(self, p: DiagGaussian, q: DiagGaussian) -> Tuple[torch.Tensor, torch.Tensor]:
        return kl_parts(p, q)

    def trust_region_loss(self, p: DiagGaussian, proj_p: DiagGaussian) -> torch.Tensor:
        """(mean_diff + cov_diff).mean() * coeff against the detached projection."""
        target = DiagGaussian(proj_p.mean.detach(), proj_p.std.detach())
        mean_diff, cov_diff = self.trust_region_value(p, target)
        return batch_mean(mean_diff + cov_diff) * self.trust_region_coeff

    def entropy_bound(self, step, initial_entropy, like: torch.Tensor) -> torch.Tensor:
        """The schedule's entropy bound at `step`, as a tensor of `like`'s
        dtype and device (-inf when no schedule is set)."""
        def t(v):
            return torch.as_tensor(v, dtype=like.dtype, device=like.device)

        if self.entropy_schedule_type is None:  # filled on the device: a host scalar would be a copy and a sync
            return torch.full((), -torch.inf, dtype=like.dtype, device=like.device)
        sched = entropy_schedule(self.entropy_schedule_type, self.total_train_steps, self.action_dim)
        e0 = t(0.0) if initial_entropy is None else initial_entropy
        return t(sched(e0, t(self.target_entropy), self.temperature, step))

    def compute_metrics(self, p: DiagGaussian, q: DiagGaussian) -> dict:
        """Constraint metrics of p against q."""
        ent_old = entropy(q)
        ent = entropy(p)
        mean_kl, cov_kl = kl_parts(p, q)
        kl_val = mean_kl + cov_kl
        mean_diff, cov_diff = self.trust_region_value(p, q)
        combined = mean_diff + cov_diff
        entropy_diff = ent_old - ent
        return {
            "kl": batch_mean(kl_val),
            "constraint": batch_mean(combined),
            "mean_constraint": batch_mean(mean_diff),
            "cov_constraint": batch_mean(cov_diff),
            "entropy": batch_mean(ent),
            "entropy_diff": batch_mean(entropy_diff),
            "kl_max": kl_val.max(),
            "constraint_max": combined.max(),
            "mean_constraint_max": mean_diff.max(),
            "cov_constraint_max": cov_diff.max(),
            "entropy_max": ent.max(),
            "entropy_diff_max": entropy_diff.max(),
        }


@dataclasses.dataclass(frozen=True)
class KLProjection(BaseProjection):
    """KL projection: closed-form mean + differentiable diag cov projection."""

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        mean_part, _ = kl_parts(p, q)
        proj_mean = mean_projection(p.mean, q.mean, mean_part, eps)
        proj_var = kl_diag_cov_projection(p.std**2, q.std**2, eps_cov)
        return DiagGaussian(proj_mean, torch.sqrt(proj_var))


def _interpolation_weight(cov_part: torch.Tensor, eps_cov) -> torch.Tensor:
    """eta = |sqrt(cov_part / eps_cov) - 1| [..., 1], the weight of the old
    covariance where the cov part exceeds its bound."""
    return torch.abs(torch.sqrt(torch.clamp(cov_part, min=1e-16) / eps_cov) - 1.0)[..., None]


@dataclasses.dataclass(frozen=True)
class FrobeniusProjection(BaseProjection):
    """Frobenius projection: cov* = (cov + eta * cov_old) / (1 + eta) with
    eta = sqrt(cov_part / eps_cov) - 1 where cov_part > eps_cov."""

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        mean_part, cov_part = frobenius_parts(p, q, scale_prec=self.scale_prec)
        proj_mean = mean_projection(p.mean, q.mean, mean_part, eps)
        eta = _interpolation_weight(cov_part, eps_cov)
        proj_var = (p.std**2 + eta * q.std**2) / (1.0 + eta + 1e-16)
        proj_std = torch.where((cov_part > eps_cov)[..., None], torch.sqrt(proj_var), p.std)
        return DiagGaussian(proj_mean, proj_std)

    def trust_region_value(self, p, q):
        return frobenius_parts(p, q, scale_prec=self.scale_prec)


@dataclasses.dataclass(frozen=True)
class WassersteinProjection(BaseProjection):
    """Commutative W2 projection: std* = (std + eta * std_old) / (1 + eta),
    eta as in the Frobenius layer on the W2 cov part."""

    def _trust_region_projection(self, p: DiagGaussian, q: DiagGaussian, eps, eps_cov) -> DiagGaussian:
        mean_part, cov_part = wasserstein_parts(p, q, scale_prec=self.scale_prec)
        proj_mean = mean_projection(p.mean, q.mean, mean_part, eps)
        eta = _interpolation_weight(cov_part, eps_cov)
        proj_std = (p.std + eta * q.std) / (1.0 + eta + 1e-16)
        return DiagGaussian(proj_mean, torch.where((cov_part > eps_cov)[..., None], proj_std, p.std))

    def trust_region_value(self, p, q):
        return wasserstein_parts(p, q, scale_prec=self.scale_prec)


def get_projection_layer(proj_type: str = "kl", **kwargs) -> BaseProjection:
    """Projection factory."""
    proj_type = proj_type.lower()
    if proj_type == "kl":
        return KLProjection(**kwargs)
    if proj_type == "frob":
        return FrobeniusProjection(**kwargs)
    if proj_type in ("w2", "wasserstein", "w2_non_com"):
        # diagonal covariances commute, so the non-commutative W2 layer
        # coincides with the commutative one (fullcov.py has the general case)
        return WassersteinProjection(**kwargs)
    if proj_type == "papi":
        from .papi import PAPIProjection

        kwargs.setdefault("entropy_first", True)
        return PAPIProjection(**kwargs)
    if proj_type in ("", "ppo", "identity", "entropy", "none"):
        return BaseProjection(**kwargs)
    raise ValueError(f"Invalid projection type {proj_type!r}; use kl, frob, w2, papi or ppo.")
