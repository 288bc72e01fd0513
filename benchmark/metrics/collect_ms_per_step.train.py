"""ms of the collect per control step: the trainer's `train/collect_time` over its control steps, mean over the window's iterations."""

from benchmark.readers import per_step_ms


def read(ctx):
    return per_step_ms(ctx, "train", "collect_s", "control_steps")
