from .base import ObsSpec, TimeStep  # noqa: F401
from .cloth import ClothEnv, ClothEnvState, ClothTaskCfg, cloth_hanging_cfg  # noqa: F401

# the reference's other tasks, not ported yet (ROADMAP.md Queue 1)
NOT_PORTED = (
    "rigid_insertion", "rigid_insertion_two_agents", "rigid_pushing", "rigid_sliding",
    "rope_closing", "rope_shaping",
)


def make_env(task: str, num_envs: int = 40, device="cuda", **kwargs):
    """Env factory keyed by task name. Only cloth_hanging is ported so far."""
    if task == "cloth_hanging":
        return ClothEnv(cloth_hanging_cfg(num_envs=num_envs, **kwargs), device=device)
    if task in NOT_PORTED:
        raise NotImplementedError(f"task {task!r} is not ported yet (ROADMAP.md Queue 1)")
    raise ValueError(f"Unknown task {task!r}; available: ['cloth_hanging']")
