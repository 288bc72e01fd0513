"""Host ms in the policy (graph build and HEPi forward) per control step of the rollout's window (unprofiled)."""

from benchmark.readers import window_host_ms


def read(ctx):
    return window_host_ms(ctx, "rollout", "policy")
