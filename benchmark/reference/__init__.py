"""The plain reference: the frozen copy's trainer (`frozen/`), built from a
cell's configuration, and its control in a lower precision.

`build(cfg, device)` gives a Trainer with the port's API (`init`,
`_collect`, `train_iteration`, `_eval_steps`, ...) computed by plain PyTorch.
`build(cfg, device, precision="control")` is the control that
`check.py`'s limits have to fail: every Dense layer's input rounded to
float8 (e4m3), the step below the configuration's bfloat16 activations, and
the env's state and observation rounded to bfloat16 after each control step,
the step below its float32 physics.

`to_reference(x, ref)` turns a state the port made (its NamedTuples, tensors
and generators) into the copy's types, with every tensor and generator
copied, so that the reference can step from the port's own state.
"""

from __future__ import annotations

from typing import Dict

import torch

from . import frozen
from .frozen.config import trainer_from_config
from .frozen.declared import named_tuples
from .frozen.models.common import Dense

FP8_MAX = 448.0  # the largest finite float8 e4m3 value


def build(cfg: Dict, device, precision: str = "stated"):
    """The reference trainer for the resolved config `cfg` on `device`;
    `precision` "stated" (the configuration's) or "control"."""
    trainer = trainer_from_config(cfg, device=device)
    if precision == "control":
        lower_precision(trainer)
    elif precision != "stated":
        raise ValueError(f"precision must be 'stated' or 'control', got {precision!r}")
    return trainer


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """`x` rounded through float8 e4m3 (saturating), gradient passed straight through."""
    q = x.clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (q - x).detach()


def bf16_round(x):
    """Every floating tensor of `x` (a tensor or nested NamedTuples / dicts) rounded to bfloat16."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: bf16_round(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(bf16_round(v) for v in x))
    return x


def lower_precision(trainer) -> None:
    """Make `trainer` the control: Dense inputs in float8, the env's state
    and observation in bfloat16 after each step."""
    for module in (trainer.policy, trainer.critic):
        for m in module.modules():
            if isinstance(m, Dense):
                m.register_forward_pre_hook(lambda _, args: (fp8_round(args[0]),) + tuple(args[1:]))
    env, step = trainer.env, trainer.env.step

    def rounded_step(state, action):
        new_state, ts = step(state, action)
        return bf16_round(new_state), ts._replace(obs=bf16_round(ts.obs))

    env.step = rounded_step


# the copy's NamedTuple types by name, for `to_reference`: every one that a
# module of the frozen package defines
REFERENCE_TYPES = named_tuples(frozen.__name__)


def copy_generator(g: torch.Generator) -> torch.Generator:
    out = torch.Generator(device=g.device)
    out.set_state(g.get_state())
    return out


def to_reference(x):
    """A copy of `x` in the reference's types: NamedTuples by name, tensors
    cloned, generators copied with their state."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, torch.Generator):
        return copy_generator(x)
    if isinstance(x, dict):
        return {k: to_reference(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return REFERENCE_TYPES[type(x).__name__](*(to_reference(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(to_reference(v) for v in x)
    return x
