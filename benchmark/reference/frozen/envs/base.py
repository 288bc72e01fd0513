"""Env API (port of `geometry_rl_tpu/envs/base.py`).

Observations are grouped dicts (scalars / position_vectors /
velocity_vectors / infos) with an `ObsSpec` describing each group's terms.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch


class ObsSpec(NamedTuple):
    """Per-group term layout: names[group][i] has dims[group][i] features."""

    names: Dict[str, List[str]]
    dims: Dict[str, List[int]]

    def group_dim(self, group: str) -> int:
        return sum(self.dims[group])


class TimeStep(NamedTuple):
    obs: Dict[str, torch.Tensor]  # group -> [B, D_group]
    reward: torch.Tensor  # [B]
    done: torch.Tensor  # [B] bool (time-out)
    info: Dict[str, torch.Tensor]
