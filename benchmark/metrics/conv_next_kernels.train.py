"""Device kernels launched inside the port's `models.conv_next` spans per policy forward of the train cell's traced slice (its second pass), which is their count per minibatch step: the slice runs one policy forward a control step (the collect's, under no_grad) and one a minibatch step, each through the same layers at the same batch of 1000. The forward only: the backward's kernels launch on autograd's engine thread, outside the span."""


def read(ctx):
    if ctx.loop != "train" or ctx.slice is None or "models.conv_next" not in ctx.slice.in_span:
        return None
    forwards = ctx.slice.control_steps + ctx.slice.minibatch_steps
    return ctx.slice.in_span["models.conv_next"][0] / forwards if forwards else None
