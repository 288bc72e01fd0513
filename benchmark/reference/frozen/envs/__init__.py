from .base import ObsSpec, TimeStep  # noqa: F401
from .cloth import ClothEnv, ClothEnvState, ClothTaskCfg, cloth_hanging_cfg  # noqa: F401
from .rigid import (  # noqa: F401
    TASK_REGISTRY,
    RigidEnv,
    RigidEnvState,
    RigidTaskCfg,
    rigid_insertion_cfg,
    rigid_insertion_two_agents_cfg,
    rigid_pushing_cfg,
    rigid_sliding_cfg,
)


def make_env(task: str, num_envs: int = 40, device="cuda", **kwargs):
    """Env factory keyed by task name (the four rigid tasks and cloth_hanging)."""
    if task in TASK_REGISTRY:
        return RigidEnv(TASK_REGISTRY[task](num_envs=num_envs, **kwargs), device=device)
    if task == "cloth_hanging":
        return ClothEnv(cloth_hanging_cfg(num_envs=num_envs, **kwargs), device=device)
    raise ValueError(f"Unknown task {task!r}; available: {sorted(TASK_REGISTRY) + ['cloth_hanging']}")
