"""The `train` loop: whole `Trainer.train_iteration` calls back to back,
from the state set-up leaves, until the window's seconds have passed; only
whole iterations count. Frames are num_envs x control steps x iterations.

Set-up's first iteration runs under the capture (it also builds and warms
up every kernel); the mix's `warmup_iterations` counts it. Once the window
has closed, `finish` runs one more iteration under the capture, from the
state the window left: the check judges both, the first from the seed, the
last from the port's own state at its start.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import torch

from benchmark.capture import TrainCapture, sample_steps
from benchmark.loops import Window, sync


class Loop:
    def __init__(self, trainer, state, cell, seed: int):
        self.trainer, self.state, self.cell, self.seed = trainer, state, cell, seed
        self.capture: Optional[Dict] = None
        self.control_steps = trainer.cfg.steps_per_batch  # per iteration
        self.minibatch_steps = trainer.cfg.ppo_epochs * trainer.num_minibatches
        self.iterations = 0  # train_iteration calls so far

    def _captured(self, draw: int, keep_start: bool) -> Dict:
        steps = sample_steps(self.seed + draw, 0, self.control_steps, self.cell.spec["check"]["env_steps"])
        with TrainCapture(self.trainer, self.state, steps, keep_start=keep_start) as cap:
            self.state, _ = self.trainer.train_iteration(self.state)
        cap.result["iterations_before"] = self.iterations
        self.iterations += 1
        return cap.result

    def setup(self) -> None:
        self.capture = {"first": self._captured(0, keep_start=False)}
        for _ in range(self.cell.mix.get("warmup_iterations", 1) - 1):
            self.state, _ = self.trainer.train_iteration(self.state)
            self.iterations += 1

    def window(self, seconds: Optional[float]) -> Window:
        """`seconds=None`: no window."""
        tr = self.trainer
        metrics = []
        sync(tr.device)
        t0 = time.perf_counter()
        while seconds is not None:
            self.state, m = tr.train_iteration(self.state)  # ends in a synchronize
            metrics.append(m)
            if time.perf_counter() - t0 >= seconds:
                break
        wall = time.perf_counter() - t0
        self.iterations += len(metrics)
        failed = sum(1 for m in metrics if not all(math.isfinite(float(v)) for k, v in m.items()
                                                   if k not in ("train/reward",)))
        return Window(seconds=wall, attempted=len(metrics), failed=failed,
                      env_steps=len(metrics) * self.control_steps * tr.num_envs,
                      collect_s=[float(m["train/collect_time"]) for m in metrics],
                      update_s=[float(m["train/update_time"]) for m in metrics])

    def finish(self) -> None:
        self.capture["last"] = self._captured(1, keep_start=True)

    @staticmethod
    def end_to_end(w: Window) -> Dict[str, float]:
        return {"train_frames_per_s": w.env_steps / w.seconds} if w.attempted else {}

    def slice(self) -> Dict[str, int]:
        """The profiled slice: a collect of `control_steps` control steps and
        `minibatch_steps` minibatch steps on its batch, the trainer's own
        calls, in about the iteration's proportion."""
        tr, sl = self.trainer, self.cell.spec["slice"]
        cfg = tr.cfg
        tr.cfg = dataclasses.replace(cfg, steps_per_batch=sl["control_steps"])
        try:
            state, batch, _ = tr._collect(self.state)
            data = tr._update_data(state, batch)
            n = data["action"].shape[0]
            gen = torch.Generator(device=tr.device).manual_seed(self.seed)
            for k in range(sl["minibatch_steps"]):
                idx = torch.randperm(n, generator=gen, device=tr.device)[: tr.mini_batch_size]
                tr._minibatch_step(state, tr._minibatch(data, idx), state.num_updates + k, state.kl_beta)
            sync(tr.device)
        finally:
            tr.cfg = cfg
        return {"control_steps": sl["control_steps"], "minibatch_steps": sl["minibatch_steps"]}
