"""Device kernels under `env.step` per control step of the rollout's traced slice."""

from benchmark.readers import kernels_in


def read(ctx):
    return kernels_in(ctx, "rollout", "env.step", "control_steps")
