"""Generalized Advantage Estimation (port of `geometry_rl_tpu/rl/gae.py`):
a reverse loop over time takes the place of the reference's reverse `lax.scan`."""

from __future__ import annotations

from typing import Tuple

import torch


def gae(
    rewards: torch.Tensor,
    values: torch.Tensor,
    dones: torch.Tensor,
    bootstrap_value: torch.Tensor,
    gamma: float = 0.99,
    lam: float = 0.95,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advantages and value targets, time-major.

    rewards, values, dones [T, E] (done = episode end after step t);
    bootstrap_value [E] = V(s_T). Returns (advantage [T, E],
    value_target = advantage + values)."""
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0)
    not_done = 1.0 - dones.to(values.dtype)
    deltas = rewards + gamma * next_values * not_done - values
    advs = torch.empty_like(deltas)
    carry = torch.zeros_like(bootstrap_value)
    for t in range(deltas.shape[0] - 1, -1, -1):
        carry = deltas[t] + gamma * lam * not_done[t] * carry
        advs[t] = carry
    return advs, advs + values
