"""ms of the update per minibatch step: the trainer's `train/update_time` over epochs x minibatches, mean over the window's iterations."""

from benchmark.readers import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "train", "update_s", "minibatch_steps")
