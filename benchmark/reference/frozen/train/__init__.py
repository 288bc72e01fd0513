from .ppo import Batch, TrainConfig, Trainer, TrainState  # noqa: F401
