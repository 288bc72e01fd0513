"""Host ms of the port's `train.optimizer` spans (both optimizer steps: clip and Adam) per minibatch step of the train window (traced runs)."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "train", "train.optimizer", "minibatch")
