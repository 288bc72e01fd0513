"""Device kernels launched inside the port's `envs.physics` spans, and inside whatever opened within them, per control step of the rollout's traced slice (its second pass)."""

from benchmark.spans import kernels_per_step


def read(ctx):
    return kernels_per_step(ctx, "rollout", "envs.physics", "control")
