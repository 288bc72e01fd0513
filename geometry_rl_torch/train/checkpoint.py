"""Checkpoint / resume with `torch.save` (port of `geometry_rl_tpu/train/checkpoint.py`).

A checkpoint is the whole training state: policy and critic parameters, both
Adam states, the observation normaliser, the env state, the generator states,
`num_updates` and `initial_entropy`, so a resumed run continues exactly.
Layout: `<directory>/<step>/state.pt` (plus `metrics.json` when given); the
`max_to_keep` newest steps are kept.

The TrainState parts are stored as plain lists and dicts (generators as their
state bytes) and restored into the structure of a template TrainState from
`trainer.init`, so the files hold only tensors and plain Python values and
load with `weights_only=True`. Under env-axis data parallelism a checkpoint
holds the whole env state: every rank gathers it, rank 0 writes it, and
each rank restores its own rows, so a checkpoint written by W processes
restores in one and the other way round. A field the checkpoint lacks or holds as None
(`kl_beta` of a checkpoint from another algorithm or an older version) keeps
the template's value. `save_tree` / `restore_tree` store any such tree alone
in the same layout: the CLI keeps PAPI's carry beside the checkpoints, in
`<checkpoints>_papi`.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import List, Optional

import torch

STATE_FILE = "state.pt"
MODULE_KEYS = ("policy", "critic")
OPTIMIZER_FIELDS = ("actor_opt", "critic_opt")


def _plain(obj):
    """A state tree as plain containers: NamedTuples as lists, generators as
    their state bytes."""
    if isinstance(obj, torch.Generator):
        return obj.get_state()
    if isinstance(obj, tuple):
        return [_plain(o) for o in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


def _restore_tree(template, saved, rows=None):
    """`saved` (from `_plain`) in the structure of `template`: tensors moved
    to the template's devices, generators set in place to the saved state.
    With `rows` (`parallel.mesh.Rows`), a saved tensor over all `rows.total`
    envs where the template holds this rank's block is cut to `rows`."""
    if saved is None:
        return template
    if isinstance(template, torch.Generator):
        template.set_state(saved)
        return template
    if isinstance(template, tuple):
        if len(saved) != len(template):
            raise ValueError(f"checkpoint holds {len(saved)} entries where the template has {len(template)}")
        return type(template)(*(_restore_tree(t, s, rows) for t, s in zip(template, saved)))
    if isinstance(template, dict):
        return {k: _restore_tree(v, saved[k], rows) for k, v in template.items()}
    if torch.is_tensor(template):
        if rows is not None and saved.ndim >= 1 and saved.shape[0] == rows.total != template.shape[0]:
            saved = saved[rows.index]
        if tuple(saved.shape) != tuple(template.shape) or saved.dtype != template.dtype:
            raise ValueError(f"checkpoint tensor {tuple(saved.shape)} {saved.dtype} does not fit "
                             f"{tuple(template.shape)} {template.dtype}")
        return saved.to(template.device)
    return saved


def checkpoint_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory) if d.isdigit() and os.path.exists(os.path.join(directory, d, STATE_FILE)))


def latest_step(directory: str) -> Optional[int]:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


def _write(directory: str, step: int, payload: dict, metrics: Optional[dict], max_to_keep: int) -> None:
    step_dir = os.path.join(directory, str(step))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, STATE_FILE)
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)  # a reader never sees half a file
    if metrics is not None:
        with open(os.path.join(step_dir, "metrics.json"), "w") as f:
            json.dump(metrics, f)
    for old in checkpoint_steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))


def _read(directory: str, step: Optional[int]) -> dict:
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"No checkpoint found in {directory}")
    return torch.load(os.path.join(directory, str(step), STATE_FILE), map_location="cpu", weights_only=True)


def save_checkpoint(directory: str, step: int, trainer, state, metrics: Optional[dict] = None, max_to_keep: int = 5) -> None:
    """Write `state` and `trainer`'s params at `step`. Under data
    parallelism every rank must call it (the env state is gathered); rank 0
    writes."""
    dp = getattr(trainer, "dp", None)
    if dp is not None:
        from ..parallel.mesh import gather_env_state

        local = trainer.env.cfg.num_envs
        state = state._replace(env_state=gather_env_state(state.env_state, dp, local),
                               obs=gather_env_state(state.obs, dp, local))
        if dp.rank != 0:
            return
    payload = {
        "policy": trainer.policy.state_dict(),
        "critic": trainer.critic.state_dict(),
        "actor_opt": state.actor_opt.state_dict(),
        "critic_opt": state.critic_opt.state_dict(),
        "state": {f: _plain(getattr(state, f)) for f in state._fields if f not in OPTIMIZER_FIELDS},
    }
    _write(directory, step, payload, metrics, max_to_keep)


def save_tree(directory: str, step: int, tree, max_to_keep: int = 5) -> None:
    """A tree of tensors (a NamedTuple such as PAPI's state) at `step`."""
    _write(directory, step, {"tree": _plain(tree)}, None, max_to_keep)


def restore_tree(directory: str, template, step: Optional[int] = None):
    """The tree saved by `save_tree`, in the structure and on the devices of
    `template`."""
    return _restore_tree(template, _read(directory, step)["tree"])


def restore_checkpoint(directory: str, trainer, state, step: Optional[int] = None, fields: Optional[tuple] = None):
    """Load the parameters into `trainer`'s modules and return `state` (a
    template from `trainer.init`) with the stored values. `fields` restores
    only those TrainState fields and keeps the template's others: the eval
    CLI uses it with another env count than training, where the env-sized
    `env_state` and `obs` do not fit."""
    payload = _read(directory, step)
    for key in MODULE_KEYS:
        getattr(trainer, key).load_state_dict(payload[key])
    fields = state._fields if fields is None else fields
    for f in OPTIMIZER_FIELDS:
        if f in fields:
            getattr(state, f).load_state_dict(payload[f])
    stored = payload["state"]
    rows = getattr(trainer, "rows", None) if getattr(trainer, "dp", None) is not None else None
    return state._replace(**{f: _restore_tree(getattr(state, f), stored[f], rows if f in ("env_state", "obs") else None)
                             for f in fields if f in stored})
