"""OnPolicyRunner-style workflow (port of `geometry_rl_tpu/train/runner.py`).

A compact runner object over the Trainer, in the shape of rsl_rl's
OnPolicyRunner: `learn()`, `save()`, `load()` and `get_inference_policy()`,
driven from plain command-line flags:

    python -m geometry_rl_torch.train.runner --task rigid_pushing --model hepi \\
        --num-envs 256 --iterations 100 --log-dir logs/onpolicy

`device` defaults to `cuda`; pass `device="cpu"` (`--device cpu`) to run on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Dict, Optional

import torch

from ..rl.obs_pipeline import obs_norm_step
from .builders import build_agent
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .logging import MetricsLogger
from .ppo import TrainConfig


class OnPolicyRunner:
    def __init__(
        self,
        task: str,
        model: str = "hepi",
        algo: str = "ppo",
        num_envs: int = 256,
        steps_per_env: int = 24,
        log_dir: Optional[str] = None,
        seed: int = 0,
        device="cuda",
        **agent_kwargs,
    ):
        self.trainer = build_agent(
            task=task, model=model, num_envs=num_envs, algo=algo,
            train_cfg=TrainConfig(algo=algo, steps_per_batch=steps_per_env), device=device, **agent_kwargs,
        )
        self.device = self.trainer.device
        self.state = self.trainer.init(torch.Generator(device=self.device).manual_seed(seed))
        self.log_dir = log_dir
        self.logger = MetricsLogger(log_dir) if log_dir else None
        self.iteration = 0

    def learn(self, num_iterations: int, log_interval: int = 1) -> None:
        for _ in range(num_iterations):
            t0 = time.time()
            self.state, metrics = self.trainer.train_iteration(self.state)
            self.iteration += 1
            if self.logger and self.iteration % log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["iteration_time"] = time.time() - t0
                self.logger.log(self.iteration, metrics)

    def save(self, path: Optional[str] = None) -> None:
        path = path or os.path.join(self.log_dir or ".", "checkpoints")
        save_checkpoint(path, self.iteration, self.trainer, self.state)

    def load(self, path: str) -> None:
        self.state = restore_checkpoint(path, self.trainer, self.state, latest_step(path))

    def get_inference_policy(self) -> Callable[[Dict[str, torch.Tensor]], torch.Tensor]:
        """Deterministic raw obs -> action (the policy mean; the normaliser
        frozen)."""
        trainer, state = self.trainer, self.state

        @torch.no_grad()
        def policy(obs):
            _, tobs = obs_norm_step(state.norm, obs, update=False)
            return trainer._policy_dist(tobs).mean

        return policy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="rigid_pushing")
    ap.add_argument("--model", default="hepi")
    ap.add_argument("--algo", default="ppo", choices=["ppo", "trpl", "kl_ppo"])
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--steps-per-env", type=int, default=24)
    ap.add_argument("--iterations", type=int, default=100)
    ap.add_argument("--log-dir", default="logs/onpolicy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default=None, help="checkpoint dir to load before learning")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from .cli import resolve_device

    runner = OnPolicyRunner(args.task, model=args.model, algo=args.algo, num_envs=args.num_envs,
                            steps_per_env=args.steps_per_env, log_dir=args.log_dir, seed=args.seed,
                            device=resolve_device(args.device))
    if args.resume:
        runner.load(args.resume)
    runner.learn(args.iterations)
    runner.save()
    print(f"done: {args.iterations} iterations -> {args.log_dir}")
    return runner


if __name__ == "__main__":
    main()
