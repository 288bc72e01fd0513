"""The `rollout` loop: the deterministic evaluation loop,
`Trainer._eval_steps(..., deterministic=True)` under `torch.no_grad`, one
generator reset once in set-up. A CUDA event at each control step's end is
read after the window: the step times, with no synchronize added per step.
The host's seconds inside `env.step` and the policy (graph build and
forward) are summed over the window's steps, by the host clock and with no
synchronize.

The mix's file gives `warmup_steps` and `fold`; the cell's file the slice's
size and the check's sampling. The capture (`RolloutCapture`) is on from the
reset to the window's end: the check judges the window's own steps.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

from benchmark.capture import Patches, RolloutCapture, sample_steps
from benchmark.loops import Window, p90, sync


class HostTimer:
    """Sums the host seconds of each patched call, by label."""

    def __init__(self):
        self.seconds: Dict[str, float] = {}

    def wrap(self, fn, label: str):
        self.seconds[label] = 0.0

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[label] += time.perf_counter() - t0

        return timed


class Loop:
    control_steps = minibatch_steps = 0  # no iterations

    def __init__(self, trainer, state, cell, seed: int):
        self.trainer, self.state, self.cell, self.seed = trainer, state, cell, seed
        self.capture: Optional[Dict] = None
        self._capture: Optional[RolloutCapture] = None
        self.steps = None

    def _next(self):
        with torch.no_grad():
            return next(self.steps)

    def setup(self) -> None:
        """The reset, the capture put on, and the mix's warm-up steps."""
        mix, check = self.cell.mix, self.cell.spec["check"]
        warm = mix["warmup_steps"]
        sampled = sample_steps(self.seed, warm, warm + check["horizon"], check["env_steps"])
        self._capture = RolloutCapture(self.trainer, sampled).__enter__()
        self.steps = self.trainer._eval_steps(self.state, 2**62, True, mix["fold"])
        for _ in range(warm):
            self._next()

    def window(self, seconds: Optional[float]) -> Window:
        """`seconds=None`: until the last step the check samples has run."""
        tr = self.trainer
        cuda = torch.device(tr.device).type == "cuda"
        marks, rewards = [], []  # CUDA events at the steps' ends (host clock marks on the CPU, which runs in step)

        def mark():
            if cuda:
                marks.append(torch.cuda.Event(enable_timing=True))
                marks[-1].record()
            else:
                marks.append(time.perf_counter())

        timer = HostTimer()
        timed = Patches([(tr.env, "step", timer.wrap(tr.env.step, "env.step")),
                         (tr, "_policy_dist", timer.wrap(tr._policy_dist, "policy"))])
        recorder = self._capture.env
        with timed:
            sync(tr.device)
            t0 = time.perf_counter()
            mark()
            while (time.perf_counter() - t0 < seconds) if seconds is not None else recorder.calls <= max(recorder.steps):
                ts = self._next()
                rewards.append(ts.reward)
                mark()
            sync(tr.device)
            wall = time.perf_counter() - t0
        self._capture.__exit__(None, None, None)
        self.capture = self._capture.result
        n = len(rewards)
        failed = int((~torch.isfinite(torch.stack(rewards)).all(dim=1)).sum()) if n else 0
        step_ms = [a.elapsed_time(b) if cuda else 1e3 * (b - a) for a, b in zip(marks, marks[1:])]
        return Window(seconds=wall, attempted=n, failed=failed, env_steps=n * tr.env.cfg.num_envs,
                      step_ms=step_ms, host_s=dict(timer.seconds))

    def finish(self) -> None:
        """Nothing: the capture closed with the window."""

    @staticmethod
    def end_to_end(w: Window) -> Dict[str, float]:
        out = {"rollout_env_steps_per_s": w.env_steps / w.seconds}
        if len(w.step_ms) >= 2:
            out["rollout_step_ms_p90"] = p90(w.step_ms)
        return out

    def slice(self) -> Dict[str, int]:
        """The profiled slice: `control_steps` more steps of the same rollout."""
        n = self.cell.spec["slice"]["control_steps"]
        for _ in range(n):
            self._next()
        sync(self.trainer.device)
        return {"control_steps": n, "minibatch_steps": 0}
