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
from .rope import RopeEnv, RopeEnvState, RopeTaskCfg, rope_closing_cfg, rope_shaping_cfg  # noqa: F401

ROPE_TASKS = {"rope_closing": rope_closing_cfg, "rope_shaping": rope_shaping_cfg}


def make_env(task: str, num_envs: int = 40, device="cuda", rows=None, **kwargs):
    """Env factory keyed by task name (the four rigid tasks, the two rope
    tasks and cloth_hanging); `rows` (`parallel.mesh.Rows`) builds this
    process's row block of a data-parallel batch of `rows.total` envs."""
    if task in TASK_REGISTRY:
        return RigidEnv(TASK_REGISTRY[task](num_envs=num_envs, **kwargs), device=device, rows=rows)
    if task == "cloth_hanging":
        return ClothEnv(cloth_hanging_cfg(num_envs=num_envs, **kwargs), device=device, rows=rows)
    if task in ROPE_TASKS:
        return RopeEnv(ROPE_TASKS[task](num_envs=num_envs, **kwargs), device=device, rows=rows)
    raise ValueError(f"Unknown task {task!r}; available: {sorted(TASK_REGISTRY) + sorted(ROPE_TASKS) + ['cloth_hanging']}")
