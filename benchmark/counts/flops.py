"""The matrix products of the work, counted on the frozen reference by
`torch.utils.flop_counter.FlopCounterMode`, never on the port: so the count
is the same whatever implements the work, and it is not 0 while the model
runs.

It counts at two small batches and extends the line to the cell's sizes
(every env's graph has the same size, and what does not grow with the
batch, such as the orientation basis, is the line's constant):
- `collect`: one control step of the collect at num_envs: the policy's
  forward and draw, the critic's forward and the env step;
- `rollout`: one control step of the deterministic rollout at num_envs;
- `update`: one minibatch step at the minibatch size: the forwards, the loss
  with its projection, the backward and Adam.
"""

from __future__ import annotations

import copy
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from .. import reference
from ..reference.frozen.rl import gaussian as G
from ..reference.frozen.rl.obs_pipeline import obs_norm_step

SIZES = (8, 16)  # the two batches counted (a multiple of the rigid tasks' 8 shapes)


def _flops(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def _count_at(cfg: Dict, n: int, device) -> Dict[str, int]:
    c = copy.deepcopy(cfg)
    c["env"]["num_envs"] = n
    c["collector"]["frames_per_batch"] = 2 * n
    c["algorithm"]["objective"]["mini_batch_size"] = n
    ref = reference.build(c, device)
    gen = torch.Generator(device=device).manual_seed(0)
    state = ref.init(gen)
    out = {}
    with torch.no_grad():
        _, tobs = obs_norm_step(state.norm, state.obs, update=True)

        def collect_step():
            dist = ref._policy_dist(tobs)
            action = G.sample(gen, dist)
            G.log_prob(dist, action)
            ref._value(tobs)
            ref.env.step(state.env_state, action)

        def rollout_step():
            ref.env.step(state.env_state, ref._policy_dist(tobs).mean)

        out["collect"], out["rollout"] = _flops(collect_step), _flops(rollout_step)
        state, batch, _ = ref._collect(state)
        data = ref._update_data(state, batch)
    mb = ref._minibatch(data, torch.arange(n, device=ref.device))
    out["update"] = _flops(lambda: ref._minibatch_step(state, mb, 0, state.kl_beta))
    return out


def count(cfg: Dict, device) -> Dict[str, float]:
    """FLOPs of a collect step and a rollout step at the config's num_envs,
    and of a minibatch step at its minibatch size."""
    (n1, n2) = SIZES
    f1, f2 = _count_at(cfg, n1, device), _count_at(cfg, n2, device)
    at = {"collect": cfg["env"]["num_envs"], "rollout": cfg["env"]["num_envs"],
          "update": cfg["algorithm"]["objective"]["mini_batch_size"]}
    return {k: f1[k] + (f2[k] - f1[k]) / (n2 - n1) * (at[k] - n1) for k in f1}


def per_env_step(cfg: Dict, flops: Dict[str, float], loop: str) -> float:
    """FLOPs per frame of training (a control step of every env, and the
    epochs' passes over it) or per env-step of the rollout."""
    B = cfg["env"]["num_envs"]
    if loop == "rollout":
        return flops["rollout"] / B
    T = max(1, cfg["collector"]["frames_per_batch"] // B)
    n_mb = max(1, T * B // cfg["algorithm"]["objective"]["mini_batch_size"])
    epochs = cfg["algorithm"]["objective"]["ppo_epochs"]
    return (T * flops["collect"] + epochs * n_mb * flops["update"]) / (T * B)
