"""What the check reads from the port's own run, taken by wrapping the
trainer's calls on its instance (the port is not edited).

`TrainCapture`, around one `train_iteration`: the raw observation of every
control step, the collected batch, the sampled env steps' inputs and
outputs, the parameters before the update, the gradient of the first
minibatch step as Adam got it, the loss of the first three and the
parameters after the third; with `keep_start`, also the trainer's state at
the iteration's start (parameters and buffers, Adam's state, normaliser,
generator, env state), from which the reference then follows the
iteration. `RolloutCapture`, around the rollout's steps: the first step's
input state and the sampled steps' inputs and outputs. An env step's
outputs are its TimeStep and the state it returns. Captures are moved to the
host, so the port's device memory stays its own.
"""

from __future__ import annotations

import random
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from .reference import copy_generator

MINIBATCH_STEPS = 3  # the update steps the reference follows


def snapshot(x, device="cpu"):
    """A copy of `x` (tensors, generators, nested NamedTuples / dicts /
    lists) on `device`, detached; a generator keeps its device and state."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, torch.Generator):
        return copy_generator(x)
    if isinstance(x, dict):
        return {k: snapshot(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(snapshot(v, device) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(snapshot(v, device) for v in x)
    return x


def sample_steps(seed: int, lo: int, hi: int, k: int) -> List[int]:
    """k distinct control steps in [lo, hi), drawn from the run's seed."""
    return sorted(random.Random(seed).sample(range(lo, hi), min(k, hi - lo)))


class Patches:
    """Attributes replaced for the length of a `with`: an object's own
    attribute is put back, one it only inherited is deleted."""

    def __init__(self, patches: List[Tuple[object, str, object]]):
        self.patches = patches
        self.saved: List = []

    def __enter__(self):
        for obj, name, value in self.patches:
            self.saved.append((obj, name, name in vars(obj), vars(obj).get(name)))
            setattr(obj, name, value)
        return self

    def __exit__(self, *exc):
        for obj, name, own, old in reversed(self.saved):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self.saved.clear()
        return False


class EnvStepRecorder:
    """Wraps `env.step`: counts the calls and, at the chosen ones, keeps the
    step's input state and observation, its action, its TimeStep and the
    state it returns. Keeps a reference to every observation when
    `keep_obs`."""

    def __init__(self, env, steps: Iterable[int], first_obs, keep_obs: bool = False):
        self.env, self.steps, self.keep_obs = env, set(steps), keep_obs
        self.calls = 0
        self.prev_obs = first_obs
        self.samples: List[Dict] = []
        self.obs: List[Dict[str, torch.Tensor]] = []
        self._step = env.step

    def __call__(self, state, action):
        sampled = self.calls in self.steps
        if sampled:
            sample = {"index": self.calls, "state": snapshot(state, action.device),
                      "obs": snapshot(self.prev_obs, action.device), "action": snapshot(action, action.device)}
        new_state, ts = self._step(state, action)
        if sampled:
            sample["ts"], sample["next"] = snapshot(ts, action.device), snapshot(new_state, action.device)
            self.samples.append(sample)
        if self.keep_obs:
            self.obs.append(ts.obs)
        self.prev_obs = ts.obs
        self.calls += 1
        return new_state, ts


def _params(module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.named_parameters()}


def adam_state(opt: torch.optim.Adam, module) -> Dict[str, Dict[str, torch.Tensor]]:
    """A copy of Adam's state of each of `module`'s parameters, by name."""
    return {k: {n: v.detach().clone() for n, v in opt.state[p].items()}
            for k, p in module.named_parameters() if p in opt.state}


def adam_grads(opt: torch.optim.Adam, module, before: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """The gradient of each parameter as Adam got it in a step, worked out
    from its state after the step and `before` it (`adam_state`; empty before
    the first): exp_avg = beta1 * exp_avg_before + (1 - beta1) * g."""
    beta1 = opt.param_groups[0]["betas"][0]
    out = {}
    for k, p in module.named_parameters():
        if p in opt.state:
            avg = opt.state[p]["exp_avg"].detach()
            if k in before:
                avg = avg - beta1 * before[k]["exp_avg"]
            out[k] = avg / (1.0 - beta1)
    return out


class TrainCapture:
    """Around one `train_iteration` of `trainer` from `state`: see the module
    docstring. `result` holds the capture once the `with` block ends."""

    def __init__(self, trainer, state, env_steps: Iterable[int], keep_start: bool = False):
        self.trainer = trainer
        self.env = EnvStepRecorder(trainer.env, env_steps, state.obs, keep_obs=True)
        self.patches: Optional[Patches] = None
        self.losses: List[torch.Tensor] = []
        self.mb_calls = 0
        self.out: Dict = {"obs0": snapshot(state.obs, trainer.device)}
        self.adam0 = {"policy": adam_state(state.actor_opt, trainer.policy),
                      "critic": adam_state(state.critic_opt, trainer.critic)}
        if keep_start:
            self.out["start"] = snapshot({
                "modules": {"policy": trainer.policy.state_dict(), "critic": trainer.critic.state_dict()},
                "adam": self.adam0, "norm": state.norm, "env_state": state.env_state, "obs": state.obs,
                "generator": state.generator}, trainer.device)
        self.result: Optional[Dict] = None

    def __enter__(self):
        tr, out = self.trainer, self.out
        collect, update, mb_loss, mb_step = tr._collect, tr._update, tr._minibatch_loss, tr._minibatch_step

        def _collect(state):
            new_state, batch, stats = collect(state)
            out["batch"], out["final_obs"] = batch, new_state.obs
            return new_state, batch, stats

        def _update(state, batch, *args, **kwargs):
            out["p0"] = {"policy": _params(tr.policy), "critic": _params(tr.critic)}
            return update(state, batch, *args, **kwargs)

        def _minibatch_loss(*args, **kwargs):
            loss, aux = mb_loss(*args, **kwargs)
            if len(self.losses) < MINIBATCH_STEPS:
                self.losses.append(loss.detach().clone())
            return loss, aux

        def _minibatch_step(state, *args, **kwargs):
            result = mb_step(state, *args, **kwargs)
            self.mb_calls += 1
            if self.mb_calls == 1:
                out["g1"] = {"policy": adam_grads(state.actor_opt, tr.policy, self.adam0["policy"]),
                             "critic": adam_grads(state.critic_opt, tr.critic, self.adam0["critic"])}
            if self.mb_calls == MINIBATCH_STEPS:
                out["p3"] = {"policy": _params(tr.policy), "critic": _params(tr.critic)}
            return result

        self.patches = Patches([(tr, "_collect", _collect), (tr, "_update", _update),
                                (tr, "_minibatch_loss", _minibatch_loss), (tr, "_minibatch_step", _minibatch_step),
                                (tr.env, "step", self.env)]).__enter__()
        return self

    def __exit__(self, *exc):
        self.patches.__exit__(*exc)
        if exc[0] is None:
            self.out.update(losses=self.losses, step_obs=self.env.obs, samples=self.env.samples)
            self.result = snapshot(self.out)
        return False


class RolloutCapture:
    """Around the rollout's steps: the input state of the first step (the
    reset) and the sampled steps. `result` once the `with` block ends."""

    def __init__(self, trainer, steps: Iterable[int]):
        self.trainer = trainer
        self.env = EnvStepRecorder(trainer.env, {0, *steps}, None)
        self.patches = Patches([(trainer.env, "step", self.env)])
        self.result: Optional[Dict] = None

    def __enter__(self):
        self.patches.__enter__()
        return self

    def __exit__(self, *exc):
        self.patches.__exit__(*exc)
        if exc[0] is None:
            self.result = snapshot({"samples": self.env.samples, "calls": self.env.calls})
        return False
