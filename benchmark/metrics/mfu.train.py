"""The whole training step's share of the bf16 peak: counted FLOPs per frame (counts/flops.py) x train_frames_per_s."""

from benchmark.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "train", "train_frames_per_s")
