"""Behaviour cloning and rollout-data recording (port of `geometry_rl_tpu/train/bc.py`).

`generate_data` rolls out the current policy and records the normalised
observation groups and the sampled actions; `behavior_cloning` fits the
policy mean to recorded actions with MSE and minibatch Adam, optionally
evaluating in the env every few epochs. A dataset is an `.npz` with the JAX
package's layout (`obs_<group>` and `action` flattened to [n_steps * B, ...],
`env_ids` int32), so a dataset recorded by either package clones in the other.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..rl import gaussian as G
from ..rl.obs_pipeline import obs_norm_step
from .ppo import Trainer, TrainState, fold_in


@torch.no_grad()
def generate_data(trainer: Trainer, state: TrainState, n_steps: int, path: Optional[str] = None) -> Dict[str, np.ndarray]:
    """Roll out the policy (sampled actions, the normaliser frozen) from a
    reset drawn from the state's generator folded with 99, and record
    (normalised observation, action) pairs; written to `path` when given."""
    env = trainer.env
    gen = fold_in(state.generator, 99)
    env_state = env.reset(gen)
    obs = env.observe(env_state)
    tobs_steps, actions = [], []
    for _ in range(n_steps):
        _, tobs = obs_norm_step(state.norm, obs, update=False)
        action = G.sample(gen, trainer._policy_dist(tobs))
        env_state, ts = env.step(env_state, action)
        tobs_steps.append(tobs)
        actions.append(action)
        obs = ts.obs

    B = env.cfg.num_envs

    def flat(steps):
        x = torch.stack(steps).cpu().numpy()  # one copy to the host for the whole rollout
        return x.reshape((n_steps * B,) + x.shape[2:])

    data = {f"obs_{k}": flat([t[k] for t in tobs_steps]) for k in tobs_steps[0]}
    data["action"] = flat(actions)
    data["env_ids"] = np.tile(np.arange(B, dtype=np.int32), n_steps)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **data)
    return data


def behavior_cloning(
    trainer: Trainer,
    state: TrainState,
    data: Dict[str, np.ndarray],
    epochs: int = 50,
    batch_size: int = 256,
    lr: float = 3e-4,
    eval_every: int = 10,
    eval_steps: int = 0,
    seed: int = 0,
) -> Tuple[TrainState, List[dict]]:
    """Fit the policy mean to the recorded actions (MSE, Adam at `lr` with
    optax's default eps 1e-8). Each epoch takes `n // batch_size` minibatches
    of numpy's permutation from `seed`, as the reference does; every
    `eval_every` epochs, with `eval_steps`, `eval_rollout` scores the policy.
    The policy's parameters are updated in place; returns the state and one
    history row per epoch."""
    dev = trainer.device
    # the dataset goes to the device once; minibatches are gathered there
    tobs = {k[len("obs_"):]: torch.tensor(v, device=dev) for k, v in data.items() if k.startswith("obs_")}
    actions = torch.tensor(data["action"], device=dev)
    env_ids = torch.tensor(data["env_ids"], device=dev).long()
    n = actions.shape[0]
    opt = torch.optim.Adam(trainer.policy.parameters(), lr=lr, eps=1e-8)

    rng = np.random.default_rng(seed)
    n_batches = max(1, n // batch_size)
    history = []
    for epoch in range(epochs):
        perm = torch.as_tensor(rng.permutation(n)[: n_batches * batch_size].reshape(n_batches, batch_size), device=dev)
        entry = {"epoch": epoch, "bc_loss": float(bc_epoch(trainer, opt, tobs, actions, env_ids, perm))}
        if eval_steps and eval_every and epoch % eval_every == 0:
            entry["eval_reward"] = float(trainer.eval_rollout(state, n_steps=eval_steps))
        history.append(entry)
    return state, history


def bc_epoch(trainer: Trainer, opt: torch.optim.Optimizer, tobs: Dict[str, torch.Tensor], actions: torch.Tensor,
             env_ids: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """One epoch of minibatch steps over the rows of `perm` [n_batches,
    batch_size]; returns the mean MSE as a device tensor (no host read)."""
    losses = []
    for idx in perm:
        dist = trainer._policy_dist({k: v[idx] for k, v in tobs.items()}, env_ids[idx])
        loss = ((dist.mean - actions[idx]) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).mean()
