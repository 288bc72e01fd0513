"""Faults planted in the system under test, to show that the check fails
them (the tests, and the readings that set the training cells' limits):

- `unchanged`: a step that returns its state unchanged (train: no Adam
  step; rollout: the env step hands back its input state);
- `half_batch`: half of the batch left out, the mean taken over the rest
  (train: each minibatch's loss over its first half; rollout: the policy
  run on the first half of the envs, its answer copied to the rest);
- `altered`: an answer altered where it is produced (the policy's mean
  action of env 0 turned the other way);
- `wrong_velocity`: an env step's answer altered where it is produced (the
  returned state's velocities of env 0 turned the other way; its positions,
  observation and reward as they were).

The exchange between chips has no fault here: every cell runs on one chip.
"""

from __future__ import annotations

from typing import Callable, Dict

from .check import VELOCITY_FIELDS


def unchanged(trainer, loop: str) -> None:
    if loop == "train":
        trainer._optimizer_step = lambda *args, **kwargs: None
        return
    env, step = trainer.env, trainer.env.step

    def stuck(state, action):
        _, ts = step(state, action)
        return state, ts._replace(obs=env.observe(state))

    env.step = stuck


def half_batch(trainer, loop: str) -> None:
    if loop == "train":
        loss = trainer._minibatch_loss

        def half(mb, *args, **kwargs):
            n = mb["action"].shape[0] // 2
            cut = {k: ({g: x[:n] for g, x in v.items()} if k == "tobs" else v[:n]) for k, v in mb.items()}
            return loss(cut, *args, **kwargs)

        trainer._minibatch_loss = half
        return
    policy = trainer._policy_dist

    def half_policy(tobs, *args, **kwargs):
        dist = policy(tobs, *args, **kwargs)
        n = dist.mean.shape[0] // 2
        return type(dist)(*(x[:n].repeat((2,) + (1,) * (x.ndim - 1))[: x.shape[0]] if n else x for x in dist))

    trainer._policy_dist = half_policy


def altered(trainer, loop: str) -> None:
    policy = trainer._policy_dist

    def moved(tobs, *args, **kwargs):
        dist = policy(tobs, *args, **kwargs)
        mean = dist.mean.clone()
        mean[0] = -mean[0]
        return dist._replace(mean=mean)

    trainer._policy_dist = moved


def _env0_velocities_turned(x, field: str = ""):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_env0_velocities_turned(getattr(x, f), f) for f in x._fields))
    if field not in VELOCITY_FIELDS:
        return x
    x = x.clone()
    x[0] = -x[0]
    return x


def wrong_velocity(trainer, loop: str) -> None:
    env, step = trainer.env, trainer.env.step

    def off(state, action):
        new_state, ts = step(state, action)
        return _env0_velocities_turned(new_state), ts

    env.step = off


FAULTS: Dict[str, Callable] = {"unchanged": unchanged, "half_batch": half_batch, "altered": altered,
                               "wrong_velocity": wrong_velocity}
