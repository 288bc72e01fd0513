"""The TRPL (trust-region projected) loss, pruned to the cells' path from
the port's `rl/losses.py` (clipped PPO, KL-penalty PPO and the data-parallel
reductions left out).

The loss takes the already-computed policy outputs (DiagGaussian) and stays
model-agnostic; its minibatch reductions are plain means.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from . import gaussian as G
from .gaussian import DiagGaussian
from .projections.base import BaseProjection


class LossInputs(NamedTuple):
    """Per-sample minibatch data (leading batch dim B)."""

    action: torch.Tensor  # [B, A]
    sample_log_prob: torch.Tensor  # [B]   log pi_old(a|s) at collection time
    advantage: torch.Tensor  # [B]
    value_target: torch.Tensor  # [B]
    old_value: torch.Tensor  # [B]   V(s) at collection time (for value clip)


def _distance_loss(pred: torch.Tensor, target: torch.Tensor, kind: str) -> torch.Tensor:
    """torchrl `distance_loss` semantics (per element, no reduction)."""
    diff = pred - target
    if kind == "l2":
        return diff**2
    if kind == "l1":
        return torch.abs(diff)
    if kind == "smooth_l1":
        absd = torch.abs(diff)
        return torch.where(absd < 1.0, 0.5 * diff**2, absd - 0.5)
    raise ValueError(f"Unknown loss_critic_type {kind!r}")


def clipped_value_loss(old_value, value, value_target, clip_value: float, kind: str = "l2") -> Tuple[torch.Tensor, torch.Tensor]:
    """Pessimistic (max) clipped value loss. Returns (per-sample loss, clip fraction)."""
    base = _distance_loss(value, value_target, kind)
    value_clipped = old_value + torch.clamp(value - old_value, -clip_value, clip_value)
    clipped = _distance_loss(value_clipped, value_target, kind)
    clip_fraction = ((clipped > base).to(value.dtype)).mean()
    return torch.maximum(base, clipped), clip_fraction


def _normalize_advantage(adv: torch.Tensor) -> torch.Tensor:
    # jnp.std: no Bessel correction
    mean = adv.mean()
    return (adv - mean) / torch.clamp(adv.std(correction=0), min=1e-6)


def _ess(log_weight: torch.Tensor) -> torch.Tensor:
    """Effective sample size / batch."""
    ess = torch.exp(2.0 * torch.logsumexp(log_weight, 0) - torch.logsumexp(2.0 * log_weight, 0))
    return ess / log_weight.shape[0]


def trpl_loss(
    new_dist: DiagGaussian,
    old_dist: DiagGaussian,
    value: torch.Tensor,
    inputs: LossInputs,
    projection: BaseProjection,
    step=0,
    initial_entropy=None,
    *,
    entropy_coef: float = 0.005,
    critic_coef: float = 0.5,
    clip_value: float = 0.2,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """TRPL objective. Returns (actor_loss, critic_loss, metrics): actor_loss
    includes the trust-region penalty and the entropy bonus; critic_loss is
    scaled by critic_coef."""
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    proj_dist = projection(new_dist, old_dist, step, initial_entropy=initial_entropy)

    log_prob = G.log_prob(proj_dist, inputs.action)
    log_weight = log_prob - inputs.sample_log_prob

    # importance-weighted gain, no ratio clipping
    loss_objective = -(torch.exp(log_weight) * advantage).mean()
    trust_region = projection.trust_region_loss(new_dist, proj_dist)

    actor_loss = loss_objective + trust_region
    entropy = G.entropy(proj_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * entropy.mean()

    critic_per_sample, clip_fraction = clipped_value_loss(
        inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type
    )
    critic_loss = critic_coef * critic_per_sample.mean()

    metrics = {
        "loss_objective": loss_objective,
        "loss_trust_region": trust_region,
        "loss_entropy": -entropy_coef * entropy.mean(),
        "loss_critic": critic_loss,
        "entropy": entropy.mean(),
        "ESS": _ess(log_weight),
        "value_clip_fraction": clip_fraction,
        "policy_std": new_dist.std.mean(),
        "policy_std_min": new_dist.std.min(),
    }
    # constraint metrics of the new dist against its projection
    metrics.update(projection.compute_metrics(new_dist, proj_dist))
    return actor_loss, critic_loss, metrics
