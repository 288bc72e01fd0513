"""The port's spans in a traced run, reduced for the per-layer readers.

In a `--trace 1` run the harness records the port's spans
(`geometry_rl_torch.utils.trace.recording()`) from before it builds the
system to the window's close, and stamps the window's ends on the spans'
clock (`time.perf_counter_ns`); `Recorded` holds both, as
`harness.Context.spans`. A `--trace 0` run records nothing, so its readers
find nothing.

`reduce` gives, per span name, the calls and the host ms of the spans that
open in the window, and their host ms per control step and per minibatch
step of the window; and set-up's spans (those that open before the window),
with their calls and host seconds. The device kernels inside a span come
from the traced slice's second pass (`trace.py`, `Slice.in_span`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple


@dataclasses.dataclass
class Recorded:
    recording: object  # geometry_rl_torch.utils.trace.Recording
    window_ns: Tuple[int, int]  # the window's ends on time.perf_counter_ns

    @functools.cached_property
    def window(self) -> Dict[str, Tuple[int, float]]:
        """name -> (calls, host seconds) of the spans that open in the window."""
        return {k: (c, s) for k, (c, s, _) in self.recording.totals(*self.window_ns).items()}

    @functools.cached_property
    def setup(self) -> Dict[str, Tuple[int, float]]:
        """name -> (calls, host seconds) of the spans that open before the window."""
        return {k: (c, s) for k, (c, s, _) in self.recording.totals(0, self.window_ns[0]).items()}


def window_steps(ctx) -> Dict[str, int]:
    """The window's control steps and minibatch steps: a train window's
    whole iterations times their steps; a rollout window's control steps."""
    if ctx.loop == "train":
        return {"control": ctx.window.attempted * ctx.control_steps,
                "minibatch": ctx.window.attempted * ctx.minibatch_steps}
    return {"control": ctx.window.attempted, "minibatch": 0}


def reduce(ctx) -> Optional[Dict]:
    """{"window": {name: {"calls", "host_ms", "host_ms_per_control_step",
    "host_ms_per_minibatch_step"}}, "setup": {name: {"calls", "host_s"}}},
    None where the run recorded no spans (a per-step figure is None where
    the window had no such steps)."""
    if ctx.spans is None:
        return None
    steps = window_steps(ctx)
    window = {}
    for name, (calls, seconds) in ctx.spans.window.items():
        window[name] = {"calls": calls, "host_ms": 1e3 * seconds}
        for per, n in steps.items():
            window[name][f"host_ms_per_{per}_step"] = 1e3 * seconds / n if n else None
    setup = {name: {"calls": calls, "host_s": seconds} for name, (calls, seconds) in ctx.spans.setup.items()}
    return {"window": window, "setup": setup}


def host_ms_per_step(ctx, loop: str, name: str, per: str) -> Optional[float]:
    """Host ms of the window's `name` spans per control or minibatch step
    (`per`: "control" or "minibatch")."""
    reduced = reduce(ctx) if ctx.loop == loop else None
    if reduced is None or name not in reduced["window"]:
        return None
    return reduced["window"][name][f"host_ms_per_{per}_step"]


def setup_s(ctx, loop: str, name: str) -> Optional[float]:
    """Host seconds of set-up's `name` spans."""
    reduced = reduce(ctx) if ctx.loop == loop else None
    if reduced is None or name not in reduced["setup"]:
        return None
    return reduced["setup"][name]["host_s"]


def kernels_per_step(ctx, loop: str, name: str, per: str) -> Optional[float]:
    """Device kernels launched inside the traced slice's `name` spans (and
    inside whatever opened within them) per control or minibatch step of
    the slice."""
    if ctx.loop != loop or ctx.slice is None or name not in ctx.slice.in_span:
        return None
    steps = getattr(ctx.slice, f"{per}_steps")
    return ctx.slice.in_span[name][0] / steps if steps else None
