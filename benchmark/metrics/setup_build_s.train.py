"""Host seconds of the port's `setup.build` span (`trainer_from_config`: env, graph builders, models, projection) in set-up of the train cells (traced runs)."""

from benchmark.spans import setup_s


def read(ctx):
    return setup_s(ctx, "train", "setup.build")
