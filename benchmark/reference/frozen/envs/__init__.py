from ..declared import declared
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


def _rigid(task: str):
    return lambda num_envs, device, **kwargs: RigidEnv(TASK_REGISTRY[task](num_envs=num_envs, **kwargs), device=device)


def _cloth(num_envs, device, **kwargs):
    return ClothEnv(cloth_hanging_cfg(num_envs=num_envs, **kwargs), device=device)


BUILT_IN = {**{task: _rigid(task) for task in TASK_REGISTRY}, "cloth_hanging": _cloth}


def make_env(task: str, num_envs: int = 40, device="cuda", **kwargs):
    """Env factory keyed by task name: the four rigid tasks, cloth_hanging,
    and the tasks a module of this package declares in `TASKS` (task ->
    `factory(num_envs=..., device=..., **kwargs)`)."""
    factories = declared(__name__, "TASKS", BUILT_IN, __file__)
    if task not in factories:
        raise ValueError(f"Unknown task {task!r}; available: {sorted(factories)}")
    return factories[task](num_envs=num_envs, device=device, **kwargs)
