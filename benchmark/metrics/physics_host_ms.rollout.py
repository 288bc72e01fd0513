"""Host ms of the port's `envs.physics` spans (the env step's physics; on the card a rigid env's is a CUDA graph replay) per control step of the rollout window (traced runs)."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "rollout", "envs.physics", "control")
