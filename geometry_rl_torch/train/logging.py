"""Metrics logging (port of `geometry_rl_tpu/train/logging.py`): JSONL always,
wandb only when configured and importable (off by default)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False, wandb_kwargs: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._fh = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                self._wandb = wandb
                wandb.init(**(wandb_kwargs or {}))
            except Exception:
                self._wandb = None  # offline or not installed: JSONL only

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        row = {"step": step, "wall_time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                row[k] = float(v)
            except (TypeError, ValueError):
                continue
        self._fh.write(json.dumps(row) + "\n")
        if self._wandb is not None:
            self._wandb.log(row, step=step)

    def log_hparams(self, hparams: dict) -> None:
        with open(os.path.join(os.path.dirname(self.path), "hparams.json"), "w") as f:
            json.dump(hparams, f, indent=2, default=str)
        if self._wandb is not None:
            self._wandb.config.update(hparams, allow_val_change=True)

    def close(self) -> None:
        self._fh.close()
        if self._wandb is not None:
            self._wandb.finish()
