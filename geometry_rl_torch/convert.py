"""Carry weights, env state and rollout batches from the JAX package into the port.

The functions take numpy arrays (the caller does the `np.asarray` on the JAX
side), so this module needs neither jax nor flax.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

from .envs.cloth import ClothEnvState
from .envs.rigid import RigidEnvState
from .envs.rope import RopeEnvState
from .rl.normalizer import VecNormState
from .rl.obs_pipeline import ObsNormState
from .sim.types import ParticleState, RigidBodyState, SceneState


def _module_name(key: str) -> str:
    """Flax auto-names (`Dense_0`, `LayerNorm_1`) -> the port's attribute
    names (`dense_0`, `layer_norm_1`); explicit names pass through."""
    return re.sub(r"(?<=[a-z])(?=[A-Z])", "_", key).lower()


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Flax param tree (numpy leaves, optionally under "params") -> a
    `state_dict` for the port's module of the same architecture. Dense
    kernels [in, out] become Linear weights [out, in]; LayerNorm `scale`
    becomes `weight`. Flax's attention projections are flattened over their
    (heads, head_dim) axes first: `query` / `key` / `value` kernels [in,
    heads, head_dim] and biases [heads, head_dim], `out` kernels [heads,
    head_dim, out]. Bare parameters (`bias`, `layer_scale`, `cls_token`, a
    non-contextual `pre_std`) pass through under their names."""
    if "params" in tree:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        for key, sub in node.items():
            if isinstance(sub, Mapping):
                walk(sub, path + [_module_name(key)])
                continue
            arr = np.array(sub, dtype=np.float32)  # a writable copy
            if key == "kernel" and arr.ndim == 3:  # an attention projection
                arr = arr.reshape(-1, arr.shape[-1]) if path[-1] == "out" else arr.reshape(arr.shape[0], -1)
            if key == "kernel":
                if arr.ndim != 2:
                    raise ValueError(f"{'.'.join(path)}.kernel has shape {arr.shape}: no Linear weight for it")
                key, arr = "weight", arr.T
            elif key == "bias" and arr.ndim == 2:  # [heads, head_dim]
                arr = arr.reshape(-1)
            elif key == "scale":
                key = "weight"
            out[".".join(path + [key])] = torch.from_numpy(np.ascontiguousarray(arr))

    walk(tree, [])
    return out


def cloth_state_from_jax(state, generator: torch.Generator, device=None) -> ClothEnvState:
    """The reference's `ClothEnvState` (numpy leaves) -> the port's. The JAX
    key is dropped; `generator` draws the port's fresh layouts."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    scene = state.scene
    return ClothEnvState(
        scene=SceneState(
            bodies=RigidBodyState(*(t(a) for a in scene.bodies)),
            particles=ParticleState(*(t(a) for a in scene.particles)),
        ),
        hanger_pos=t(state.hanger_pos),
        episode_step=t(state.episode_step, torch.int32),
        generator=generator,
        prev_action=t(state.prev_action),
    )


def rigid_state_from_jax(state, generator: torch.Generator, device=None) -> RigidEnvState:
    """The reference's `RigidEnvState` (numpy leaves) -> the port's. The JAX
    key is dropped; `generator` draws the port's fresh poses."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    return RigidEnvState(
        scene=SceneState(bodies=RigidBodyState(*(t(a) for a in state.scene.bodies))),
        episode_step=t(state.episode_step, torch.int32),
        generator=generator,
        prev_action=t(state.prev_action),
    )


def rope_state_from_jax(state, generator: torch.Generator, device=None) -> RopeEnvState:
    """The reference's `RopeEnvState` (numpy leaves) -> the port's. The JAX
    key is dropped; `generator` draws the port's fresh layouts."""

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    scene = state.scene
    return RopeEnvState(
        scene=SceneState(
            bodies=RigidBodyState(*(t(a) for a in scene.bodies)),
            particles=ParticleState(*(t(a) for a in scene.particles)),
        ),
        target_yaw=t(state.target_yaw),
        hanger_xy=t(state.hanger_xy),
        episode_step=t(state.episode_step, torch.int32),
        generator=generator,
        prev_action=t(state.prev_action),
    )


def obs_norm_from_jax(norm, device=None) -> ObsNormState:
    """The reference's `ObsNormState` (numpy leaves) -> the port's."""
    return ObsNormState(
        *(VecNormState(*(torch.as_tensor(np.array(a), dtype=torch.float32, device=device) for a in v)) for v in norm)
    )


def batch_from_jax(batch, device=None):
    """The reference's rollout `Batch` (numpy leaves) -> the port's."""
    from .train.ppo import Batch

    def t(a):
        return torch.as_tensor(np.array(a), device=device)

    return Batch(tobs={k: t(v) for k, v in batch.tobs.items()}, **{f: t(getattr(batch, f)) for f in Batch._fields if f != "tobs"})
