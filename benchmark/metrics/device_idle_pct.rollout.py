"""The device's idle share of the rollout cells' traced slice: 100 - kernel time over wall time."""

from benchmark.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "rollout")
