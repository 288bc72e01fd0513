"""The whole rollout step's share of the bf16 peak: counted FLOPs per env-step (counts/flops.py) x rollout_env_steps_per_s."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "rollout", "rollout_env_steps_per_s")
