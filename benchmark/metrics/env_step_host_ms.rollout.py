"""Host ms in `env.step` per control step of the rollout's window (unprofiled)."""

from benchmark.readers import window_host_ms


def read(ctx):
    return window_host_ms(ctx, "rollout", "env.step")
