"""On-policy losses (port of `geometry_rl_tpu/rl/losses.py`): TRPL
(trust-region projected), clipped PPO and adaptive KL-penalty PPO.

Losses take the already-computed policy outputs (DiagGaussian) and stay
model-agnostic. Their minibatch reductions go through `parallel.mesh`'s
`batch_*` functions: plain means in one process; under env-axis data
parallelism each process's share of the global minibatch.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import math

import torch

from ..parallel.mesh import batch_global_mean, batch_logsumexp, batch_mean, batch_size, batch_std, batch_total
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
    clip_fraction = batch_mean((clipped > base).to(value.dtype))
    return torch.maximum(base, clipped), clip_fraction


def _normalize_advantage(adv: torch.Tensor) -> torch.Tensor:
    # jnp.std: no Bessel correction
    mean = batch_global_mean(adv)
    return (adv - mean) / torch.clamp(batch_std(adv, mean), min=1e-6)


def _ess(log_weight: torch.Tensor) -> torch.Tensor:
    """Effective sample size / batch."""
    ess = torch.exp(2.0 * batch_logsumexp(log_weight) - batch_logsumexp(2.0 * log_weight))
    return ess / batch_size(log_weight)


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
    loss_objective = -batch_mean(torch.exp(log_weight) * advantage)
    trust_region = projection.trust_region_loss(new_dist, proj_dist)

    actor_loss = loss_objective + trust_region
    entropy = G.entropy(proj_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * batch_mean(entropy)

    critic_per_sample, clip_fraction = clipped_value_loss(
        inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type
    )
    critic_loss = critic_coef * batch_mean(critic_per_sample)

    metrics = {
        "loss_objective": loss_objective,
        "loss_trust_region": trust_region,
        "loss_entropy": -entropy_coef * batch_mean(entropy),
        "loss_critic": critic_loss,
        "entropy": batch_mean(entropy),
        "ESS": _ess(log_weight),
        "value_clip_fraction": clip_fraction,
        "policy_std": batch_mean(new_dist.std),
        "policy_std_min": new_dist.std.min(),
    }
    # constraint metrics of the new dist against its projection
    metrics.update(projection.compute_metrics(new_dist, proj_dist))
    return actor_loss, critic_loss, metrics


# the band that kl_pen_ppo_loss clamps its adaptive beta to
KL_PEN_BETA_MIN = 1e-2
KL_PEN_BETA_MAX = 1e6


def adapt_kl_beta(beta: torch.Tensor, kl: torch.Tensor, dtarg: float, increment: float, decrement: float) -> torch.Tensor:
    """beta * increment where kl > 1.5 dtarg, * decrement where kl < dtarg /
    1.5, clamped to [KL_PEN_BETA_MIN, KL_PEN_BETA_MAX]. In f32 beta is
    multiplied by `decrement` once per minibatch, so a long low-KL stretch
    would underflow it to exactly 0, which is absorbing; the floor keeps it
    positive and the ceiling finite."""
    new_beta = torch.where(kl > dtarg * 1.5, beta * increment, torch.where(kl < dtarg / 1.5, beta * decrement, beta))
    return torch.clamp(new_beta, KL_PEN_BETA_MIN, KL_PEN_BETA_MAX)


def _critic_loss(value, inputs: LossInputs, clip_value, loss_critic_type: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-sample critic loss, value clip fraction); unclipped, with a clip
    fraction of 0, where clip_value is None."""
    if clip_value is not None:
        return clipped_value_loss(inputs.old_value, value, inputs.value_target, clip_value, loss_critic_type)
    return _distance_loss(value, inputs.value_target, loss_critic_type), torch.zeros((), device=value.device)


def kl_pen_ppo_loss(
    new_dist: DiagGaussian,
    old_dist: DiagGaussian,
    value: torch.Tensor,
    inputs: LossInputs,
    beta: torch.Tensor,
    *,
    dtarg: float = 0.01,
    increment: float = 2.0,
    decrement: float = 0.5,
    entropy_coef: float = 0.0,
    critic_coef: float = 1.0,
    clip_value: Optional[float] = None,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = False,
    adapt: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Adaptive KL-penalty PPO: surrogate -(ratio * advantage) + beta *
    KL(old || new), with the exact diagonal-Gaussian KL. After the loss is
    formed, beta adapts for the next step (`adapt_kl_beta`); with
    adapt=False (kl_beta_interval "iteration") it stays, and the trainer
    adapts it once per iteration. The critic loss is unclipped by default
    (clip_value=None). Returns (actor_loss, critic_loss, new_beta, metrics)."""
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    log_weight = G.log_prob(new_dist, inputs.action) - inputs.sample_log_prob
    gain = torch.exp(log_weight) * advantage
    # the mean / cov split says where the KL budget goes
    kl_maha_part, kl_cov_part = G.kl_parts(old_dist, new_dist)
    kl_mean = batch_mean(kl_maha_part + kl_cov_part)
    actor_loss = -batch_mean(gain) + beta * kl_mean

    entropy = G.entropy(new_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * batch_mean(entropy)

    critic_per_sample, clip_fraction = _critic_loss(value, inputs, clip_value, loss_critic_type)
    critic_loss = critic_coef * batch_mean(critic_per_sample)

    if adapt:
        new_beta = adapt_kl_beta(beta, batch_total(kl_mean), dtarg, increment, decrement)
    else:
        new_beta = torch.clamp(beta, KL_PEN_BETA_MIN, KL_PEN_BETA_MAX)

    metrics = {
        "loss_objective": -batch_mean(gain),
        "loss_entropy": -entropy_coef * batch_mean(entropy) if entropy_bonus else torch.zeros((), device=value.device),
        "loss_critic": critic_loss,
        "entropy": batch_mean(entropy),
        "ESS": _ess(log_weight),
        "kl": kl_mean,
        "kl_mean_part": batch_mean(kl_maha_part),
        "kl_cov_part": batch_mean(kl_cov_part),
        "kl_penalty_beta": beta,
        "kl_penalty_beta_max": beta,
        "value_clip_fraction": clip_fraction,
        "policy_std": batch_mean(new_dist.std),
        "policy_std_min": new_dist.std.min(),
    }
    return actor_loss, critic_loss, new_beta, metrics


def ppo_clip_loss(
    new_dist: DiagGaussian,
    value: torch.Tensor,
    inputs: LossInputs,
    *,
    clip_epsilon: float = 0.2,
    entropy_coef: float = 0.005,
    critic_coef: float = 0.5,
    clip_value: Optional[float] = 0.2,
    loss_critic_type: str = "l2",
    normalize_advantage: bool = True,
    entropy_bonus: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, Dict[str, torch.Tensor]]:
    """Clipped PPO with value clipping. Returns (actor_loss, critic_loss,
    metrics)."""
    advantage = inputs.advantage
    if normalize_advantage:
        advantage = _normalize_advantage(advantage)

    log_weight = G.log_prob(new_dist, inputs.action) - inputs.sample_log_prob
    gain1 = torch.exp(log_weight) * advantage
    log_weight_clip = torch.clamp(log_weight, math.log1p(-clip_epsilon), math.log1p(clip_epsilon))
    gain2 = torch.exp(log_weight_clip) * advantage
    loss_objective = -batch_mean(torch.minimum(gain1, gain2))

    actor_loss = loss_objective
    entropy = G.entropy(new_dist)
    if entropy_bonus:
        actor_loss = actor_loss - entropy_coef * batch_mean(entropy)

    critic_per_sample, clip_fraction = _critic_loss(value, inputs, clip_value, loss_critic_type)
    critic_loss = critic_coef * batch_mean(critic_per_sample)

    metrics = {
        "loss_objective": loss_objective,
        "loss_entropy": -entropy_coef * batch_mean(entropy),
        "loss_critic": critic_loss,
        "entropy": batch_mean(entropy),
        "ESS": _ess(log_weight),
        "clip_fraction": batch_mean((gain2 < gain1).to(value.dtype)),
        "value_clip_fraction": clip_fraction,
        "policy_std": batch_mean(new_dist.std),
        "policy_std_min": new_dist.std.min(),
    }
    return actor_loss, critic_loss, metrics
