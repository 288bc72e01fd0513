"""Host seconds of the port's `setup.init` span (`Trainer.init`: the reset, the calibration and the optimizers' state) in set-up of the train cells (traced runs)."""

from benchmark.spans import setup_s


def read(ctx):
    return setup_s(ctx, "train", "setup.init")
