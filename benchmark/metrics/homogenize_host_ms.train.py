"""Host ms of the port's `graphs.homogenize` spans (each merge of a hetero graph into one node and edge set: EMPN's policy and the DeepSets critic) per minibatch step of the train window (traced runs): the window's whole total over its minibatch steps, the collect's calls with the update's."""

from benchmark.spans import host_ms_per_step


def read(ctx):
    return host_ms_per_step(ctx, "train", "graphs.homogenize", "minibatch")
