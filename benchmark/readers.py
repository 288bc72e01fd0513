"""What the per-layer metrics' readers (`metrics/<name>.py`) share. Each
helper takes the run's `harness.Context` and returns None where the run
has nothing to read: another loop, no traced slice, no such calls, no peak
known for the device."""

from __future__ import annotations

from statistics import mean
from typing import Optional

from .counts.flops import per_env_step


def traced(ctx, loop: str) -> bool:
    return ctx.loop == loop and ctx.slice is not None


def per_step_ms(ctx, loop: str, seconds_field: str, per: str) -> Optional[float]:
    """The trainer's own timing (`train/collect_time` or `update_time`) per
    control or minibatch step, mean over the window's iterations, in ms."""
    values = getattr(ctx.window, seconds_field)
    steps = getattr(ctx, per)
    if ctx.loop != loop or not values or not steps:
        return None
    return 1e3 * mean(values) / steps


def kernels_in(ctx, loop: str, label: str, per: str) -> Optional[float]:
    """Device kernels inside `label`'s range per control or minibatch step of the slice."""
    if not traced(ctx, loop) or not getattr(ctx.slice, per):
        return None
    return ctx.slice.in_range[label][0] / getattr(ctx.slice, per)


def window_host_ms(ctx, loop: str, label: str) -> Optional[float]:
    """Host ms in the window's `label` calls (`loops/rollout.py`'s timer,
    unprofiled) per control step of the window."""
    seconds = ctx.window.host_s.get(label)
    if ctx.loop != loop or seconds is None or not ctx.window.attempted:
        return None
    return 1e3 * seconds / ctx.window.attempted


def roofline_pct(ctx, loop: str, label: str) -> Optional[float]:
    """100 x the least time of the range's calls (the larger of bytes over
    the HBM rate and f32 operations over the f32 rate, summed over calls) over
    the device time of every kernel inside the calls' ranges."""
    if not traced(ctx, loop) or ctx.peak is None:
        return None
    calls = ctx.slice.calls[label]
    device_s = ctx.slice.in_range[label][1]
    if not calls.bytes or device_s <= 0:
        return None
    flops = calls.flops or [0] * len(calls.bytes)
    bound = sum(max(b / ctx.peak["hbm_bytes"], f / ctx.peak["f32_flops"]) for b, f in zip(calls.bytes, flops))
    return 100.0 * bound / device_s


def idle_pct(ctx, loop: str) -> Optional[float]:
    """100 - the device's busy share of the slice's wall time."""
    if not traced(ctx, loop) or ctx.slice.wall_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.slice.busy_s / ctx.slice.wall_s)


def mfu_pct(ctx, loop: str, rate_metric: str) -> Optional[float]:
    """Counted FLOPs per env-step (the frozen reference's matrix products)
    x the window's rate over the device's bf16 peak, in %."""
    rate = ctx.end_to_end.get(rate_metric)
    if ctx.loop != loop or ctx.flops is None or ctx.peak is None or not rate:
        return None
    return 100.0 * per_env_step(ctx.config, ctx.flops, loop) * rate / ctx.peak["bf16_flops"]
