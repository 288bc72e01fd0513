"""Training entry point (port of `geometry_rl_tpu/train/cli.py`).

Load a task config, build the agent on one device, loop collect + update
iterations, log per-iteration scalars (the reference's key set), checkpoint
best / interval, resume.

    python -m geometry_rl_torch.train.cli --config cloth_hanging_multi_hepi_trpl \\
        --override env.kwargs.use_pallas_solver=true collector.total_frames=200000

`--device` defaults to `cuda` and raises where there is no card; pass
`--device cpu` to train on the CPU with the kernels' plain versions.
`algo=trpl|ppo|kl_ppo` picks the algorithm; with
`algorithm.objective.papi_steps=true` each iteration ends in PAPI's
post-update steps, and PAPI's carry is checkpointed beside the checkpoints
(`<checkpoints>_papi`). Multi-device data parallelism, multi-host launches and
in-training video are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import ast
import os
import time
from datetime import datetime

import torch

MULTIHOST_VARS = ("GEOMRL_MULTIHOST", "GEOMRL_COORDINATOR", "GEOMRL_NUM_PROCESSES", "GEOMRL_PROCESS_ID")


def parse_overrides(pairs):
    """`a.b.c=value` pairs -> a nested dict; Hydra-style lowercase booleans,
    Python literals, else the string."""
    out = {}
    for pair in pairs or []:
        key, _, val = pair.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if val.lower() in ("true", "false"):
            node[parts[-1]] = val.lower() == "true"
            continue
        try:
            node[parts[-1]] = ast.literal_eval(val)
        except (ValueError, SyntaxError):
            node[parts[-1]] = val
    return out


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: torch.cuda.is_available() is False; pass --device cpu to run on the CPU"
        )
    return device


def check_supported(cfg: dict, device: torch.device) -> None:
    """Raise on the reference's features this port does not run yet, rather
    than ignoring them."""
    if any(os.environ.get(v) for v in MULTIHOST_VARS):
        raise NotImplementedError("multi-host launches are not ported yet (ROADMAP.md Queue 1 item 14)")
    dp = cfg.get("parallel", {}).get("data_parallel", "auto")
    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    if dp is True or (dp == "auto" and n_dev > 1 and cfg["env"]["num_envs"] % n_dev == 0):
        raise NotImplementedError(
            f"data parallelism over {n_dev} devices is not ported yet (ROADMAP.md Queue 1 item 14); "
            "set parallel.data_parallel=false to train on one device"
        )
    if cfg["env"].get("video"):
        raise NotImplementedError("in-training video (env.video) needs train/render.py, not ported yet (ROADMAP.md Queue 1 item 13)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="config name or path")
    ap.add_argument("--override", nargs="*", default=[], help="dot.key=value overrides")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..config import load_config, trainer_from_config
    from .checkpoint import latest_step, restore_checkpoint, restore_tree
    from .logging import MetricsLogger

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.override))
    check_supported(cfg, device)
    trainer = trainer_from_config(cfg, device=device)

    stamp = datetime.now().strftime("%y_%m_%d-%H_%M_%S")
    log_dir = os.path.join(cfg["logger"]["log_dir"], f"{cfg['task']}_{cfg['model']}_{cfg['algo']}_{stamp}")
    logger = MetricsLogger(log_dir, use_wandb=cfg["logger"].get("wandb", False))
    logger.log_hparams(cfg)

    state = trainer.init(torch.Generator(device=device).manual_seed(cfg["seed"]))
    papi_state = trainer.papi_init(state) if trainer.cfg.papi_steps else None
    start_iter = 0
    load_dir = args.resume or cfg["logger"]["checkpoint"].get("load_dir")
    if load_dir:
        step = latest_step(load_dir)
        state = restore_checkpoint(load_dir, trainer, state, step)
        start_iter = step + 1
        print(f"Resumed from {load_dir} @ iteration {step}")
        if papi_state is not None:
            # without PAPI's carry a resumed run would restart at lr_scale 1
            # with an empty history
            papi_dir = load_dir.rstrip("/") + "_papi"
            if latest_step(papi_dir) is not None:
                papi_state = restore_tree(papi_dir, papi_state)
                print(f"Resumed PAPI state from {papi_dir}")
            else:
                print(f"WARNING: no PAPI state at {papi_dir}; LR anneal/history reset")

    ckpt_cfg = cfg["logger"]["checkpoint"]
    start = time.time()
    train_loop(
        trainer, state, logger, start_iter,
        total_iterations=max(1, cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"]),
        save_interval=ckpt_cfg["save_interval"], save_best=ckpt_cfg["save_best"],
        max_to_keep=ckpt_cfg.get("max_to_keep", 5), log_dir=log_dir, papi_state=papi_state,
    )
    print(f"Training took {time.time() - start:.1f}s")
    logger.close()
    return log_dir


def train_loop(trainer, state, logger, start_iter, total_iterations, save_interval, save_best, max_to_keep, log_dir,
               papi_state=None):
    from .checkpoint import save_checkpoint, save_tree

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    frames_per_batch = trainer.cfg.steps_per_batch * trainer.env.cfg.num_envs
    best_reward = -float("inf")

    def save(directory, step, **kw):
        save_checkpoint(directory, step, trainer, state, max_to_keep=max_to_keep, **kw)

    for i in range(start_iter, total_iterations):
        t0 = time.time()
        if papi_state is not None:
            state, papi_state, metrics = trainer.train_iteration_papi(state, papi_state)
        else:
            state, metrics = trainer.train_iteration(state)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["train/iteration_time"] = time.time() - t0
        metrics["train/frames"] = (i + 1) * frames_per_batch
        logger.log(i, metrics)

        reward = metrics.get("train/reward", float("nan"))
        print(
            f"iter {i}/{total_iterations} reward={reward:.3f} kl={metrics.get('kl', 0):.4f} "
            f"ESS={metrics.get('ESS', 0):.3f} ({metrics['train/iteration_time']:.1f}s)",
            flush=True,
        )
        if save_interval > 0 and i % save_interval == 0:
            save(ckpt_dir, i, metrics={"reward": reward})
            if papi_state is not None:
                save_tree(ckpt_dir + "_papi", i, papi_state, max_to_keep=max_to_keep)
        if save_best and reward == reward and reward > best_reward:  # NaN-safe
            best_reward = reward
            save(os.path.join(log_dir, "best"), i, metrics={"reward": reward})
    save(ckpt_dir, total_iterations - 1)
    if papi_state is not None:
        save_tree(ckpt_dir + "_papi", total_iterations - 1, papi_state, max_to_keep=max_to_keep)
    return state


if __name__ == "__main__":
    main()
