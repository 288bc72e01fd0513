from .mesh import (  # noqa: F401
    DataParallel,
    Rows,
    env_rows,
    gather_env_state,
    replicate,
    shard_env_state,
    shard_train_state,
)
from .multihost import is_main_process, local_device, maybe_initialize_distributed  # noqa: F401
