"""Flat (non-graph) observation pipeline: the MLP agent family's data layer
(port of `geometry_rl_tpu/graphs/flat.py`).

The transformed observation groups are flattened and concatenated into one
feature vector. It plugs into the Trainer through the graph builders'
`build()` protocol and returns `(None, flat_obs)`.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .rigid import noise_like

# normalised groups, in a fixed feature order; `infos` carries graph-only
# integer metadata and is excluded, as are the raw un-normalised vector copies
FLAT_GROUPS = ("scalars", "norm_position_vectors", "norm_velocity_vectors")
# the obs-spec group each flat group is the normalised form of
_SPEC_GROUP = {"scalars": "scalars", "norm_position_vectors": "position_vectors", "norm_velocity_vectors": "velocity_vectors"}


class FlatObsBuilder:
    """build(tobs) -> (None, [N, flat_dim]) flat features for MLP policies/critics."""

    def __init__(self, flat_dim: int, training_noise: bool = False, training_noise_std: float = 1e-2):
        self.flat_dim = flat_dim
        self.training_noise = training_noise
        self.training_noise_std = training_noise_std

    @classmethod
    def from_env(cls, env, dist_as_pos: bool = True, **kw) -> "FlatObsBuilder":
        kw.pop("full_graph_obs", None)  # graph-only option
        return cls(sum(env.obs_spec.group_dim(_SPEC_GROUP[g]) for g in FLAT_GROUPS), **kw)

    def build(
        self,
        tobs: Dict[str, torch.Tensor],
        env_ids: Optional[torch.Tensor] = None,
        noise_generator: Optional[torch.Generator] = None,
    ) -> Tuple[None, torch.Tensor]:
        """`env_ids` changes nothing (no per-env topology); `noise_generator`
        draws the training noise, on the two vector groups only, when the
        builder has it on."""
        parts = []
        for g in FLAT_GROUPS:
            x = tobs[g].reshape(tobs[g].shape[0], -1)
            if noise_generator is not None and self.training_noise and g != "scalars":
                x = x + noise_like(x, noise_generator, self.training_noise_std)
            parts.append(x)
        return None, torch.cat(parts, dim=-1)
