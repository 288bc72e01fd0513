"""Host ms of the port's `models.conv_next` spans (each SeparableFiberBundleConvNext forward, EMPN's layers) per minibatch step of the train window (traced runs): the window's whole total over its minibatch steps, the collect's policy forwards (one a control step) with the update's (one a minibatch step)."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "train", "models.conv_next", "minibatch")
