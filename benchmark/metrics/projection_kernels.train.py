"""Device kernels under the KL projection per minibatch step in the traced slice."""

from benchmark.readers import kernels_in


def read(ctx):
    return kernels_in(ctx, "train", "projection", "minibatch_steps")
