"""Trajectory rendering (port of `geometry_rl_tpu/train/render.py`).

`collect_frames` rolls the policy in every env and snapshots one env's scene
per control step (bodies, target, the cloth hook or the rope's pole,
particles, the object mesh, the task distance) until that env's first
episode end; `record_rollout` draws the frames with matplotlib into an
animated GIF (Pillow) or MP4.

    from geometry_rl_torch.train.render import record_rollout
    record_rollout(trainer, state, "episode.gif", n_steps=100, env_index=0)

The rollout keeps every snapshot on the device and copies them to the host
once at its end, so it does not synchronise per step. matplotlib is needed by
`record_rollout` only, and imported there.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..rl import gaussian as G
from ..rl.obs_pipeline import obs_norm_step
from ..utils.math import transform_points
from .ppo import fold_in


@torch.no_grad()
def frame_tensors(trainer, state, n_steps: int, env_index: int = 0, deterministic: bool = True
                  ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The rollout of `collect_frames` on the device: each snapshot stacked
    over all `n_steps` control steps ([n_steps, ...]) and env `env_index`'s
    done flags [n_steps]. Reset from the state's generator folded with 1234."""
    env, i = trainer.env, env_index
    gen = fold_in(state.generator, 1234)
    env_state = env.reset(gen)
    obs = env.observe(env_state)
    steps: List[Dict[str, torch.Tensor]] = []
    dones = []
    for _ in range(n_steps):
        _, tobs = obs_norm_step(state.norm, obs, update=False)
        dist = trainer._policy_dist(tobs)
        action = dist.mean if deterministic else G.sample(gen, dist)
        env_state, ts = env.step(env_state, action)
        obs = ts.obs
        dones.append(ts.done[i])
        bodies = env_state.scene.bodies
        snap = {"bodies": bodies.pos[i]}
        if "object_target_distance" in ts.info:
            snap["task_distance"] = ts.info["object_target_distance"][i]
        if hasattr(env.cfg, "target_body"):
            snap["target"] = bodies.pos[i, env.cfg.target_body]
        if hasattr(env_state, "hanger_pos"):
            snap["hanger"] = env_state.hanger_pos[i]
        elif hasattr(env_state, "hanger_xy"):
            snap["hanger"] = env_state.hanger_xy[i]
        if env_state.scene.particles is not None:
            snap["particles"] = env_state.scene.particles.pos[i]
        if hasattr(env, "obj_points"):
            obj = env.cfg.object_body
            snap["mesh"] = transform_points(env.obj_points[i : i + 1], bodies.pos[i : i + 1, obj], bodies.quat[i : i + 1, obj])[0]
        steps.append(snap)
    return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}, torch.stack(dones)


def collect_frames(trainer, state, n_steps: int, env_index: int = 0, deterministic: bool = True) -> List[dict]:
    """Roll the policy and snapshot env `env_index`'s scene after each control
    step, stopping before its first done: the env auto-resets inside `step`,
    so the scene after it belongs to the next episode."""
    env = trainer.env
    stacked, done = frame_tensors(trainer, state, n_steps, env_index, deterministic)
    stacked = {k: v.cpu().numpy() for k, v in stacked.items()}  # one copy to the host for the rollout
    done = done.cpu().numpy()
    n = int(np.argmax(done)) if done.any() else n_steps
    mask = env.obj_point_mask[env_index].cpu().numpy() > 0.5 if hasattr(env, "obj_points") else None
    frames = []
    for t in range(n):
        frame = {"bodies": stacked["bodies"][t]}
        if "task_distance" in stacked:
            frame["task_distance"] = float(stacked["task_distance"][t])
        if "target" in stacked:
            frame["target"] = stacked["target"][t]
        if "hanger" in stacked:
            h = stacked["hanger"][t]
            if h.shape[-1] == 3:  # cloth: a capsule hook along +y
                frame["hook"] = np.stack([h, h + np.array([0.0, getattr(env.cfg, "hanger_half_len", 0.5) * 2, 0.0])])
            else:  # rope: a vertical pole
                frame["hook"] = np.stack([np.array([h[0], h[1], 0.0]), np.array([h[0], h[1], 1.0])])
        if "particles" in stacked:
            frame["particles"] = stacked["particles"][t]
        if mask is not None:
            frame["mesh"] = stacked["mesh"][t]
            frame["mesh_mask"] = mask
        frames.append(frame)
    return frames


def record_rollout(trainer, state, path: str, n_steps: int = 100, env_index: int = 0, deterministic: bool = True,
                   fps: int = 25, elev: float = 25.0, azim: float = 45.0) -> str:
    """Render a policy rollout of one env to a GIF (`.gif`, Pillow) or MP4
    (ffmpeg) at `path`. Raises ImportError where matplotlib is missing."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(f"record_rollout draws with matplotlib, which is not installed: {e}") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import animation

    frames = collect_frames(trainer, state, n_steps, env_index, deterministic)
    if not frames:
        raise ValueError(f"env {env_index} ended its episode on the first step: nothing to draw")
    pts = np.concatenate([f["bodies"] for f in frames] + [f["particles"] for f in frames if "particles" in f], axis=0)
    lo, hi = pts.min(0) - 0.2, pts.max(0) + 0.2

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.view_init(elev=elev, azim=azim)

    def draw(i):
        ax.cla()
        f = frames[i]
        ax.scatter(*f["bodies"].T, c="tab:red", s=60, marker="s", label="bodies")
        if "target" in f:
            ax.scatter(*f["target"].T, c="tab:orange", s=120, marker="*", label="target")
        if "hook" in f:
            ax.plot(*f["hook"].T, c="tab:purple", lw=4, label="hook")
        if "mesh" in f:
            ax.scatter(*f["mesh"][f["mesh_mask"]].T, c="tab:blue", s=8, label="object mesh")
        if "particles" in f:
            ax.scatter(*f["particles"].T, c="tab:green", s=6, label="particles")
        ax.set_xlim(lo[0], hi[0])
        ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        title = f"step {i}"
        if "task_distance" in f:
            title += f"  d={f['task_distance']:.3f}"
        ax.set_title(title)
        if i == 0:
            ax.legend(loc="upper right", fontsize=7)

    anim = animation.FuncAnimation(fig, draw, frames=len(frames), interval=1000 / fps)
    writer = animation.PillowWriter(fps=fps) if path.endswith(".gif") else animation.FFMpegWriter(fps=fps)
    anim.save(path, writer=writer)
    plt.close(fig)
    return path
