"""Device kernels per minibatch step (loss, projection, backward, Adam) in the traced slice."""

from benchmark.readers import kernels_in


def read(ctx):
    return kernels_in(ctx, "train", "minibatch_step", "minibatch_steps")
