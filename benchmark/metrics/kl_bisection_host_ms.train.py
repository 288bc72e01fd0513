"""Host ms of the port's `rl.kl_bisection` spans (the KL projection's bisection) per minibatch step of the train window (traced runs)."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "train", "rl.kl_bisection", "minibatch")
