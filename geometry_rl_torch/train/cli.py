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
(`<checkpoints>_papi`). `env.video=true` renders a GIF of env 0 every
`env.video_interval` iterations (`train/render.py`).

Data parallelism over the env axis (`parallel.data_parallel`: "auto", true or
false): a multi-process launch (`parallel/multihost.py`'s variables, one
process per card) splits `env.num_envs` over the processes; one process that
sees several cards starts one worker per card itself. Rank 0 logs, prints and
writes the checkpoints, which hold the whole env state. `--dist-backend`
names the collective backend (default: nccl on CUDA, gloo on the CPU).
"""

from __future__ import annotations

import argparse
import ast
import os
import socket
import sys
import time
from datetime import datetime

import torch
import torch.distributed as dist


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


def data_parallel_width(cfg: dict, n: int, multi_process: bool) -> int:
    """How many processes split the env axis (1: none) over `n` devices
    (the processes of a multi-process launch, else the cards this process
    sees), by the JAX CLI's rules: "auto" and true split it where
    `env.num_envs` divides over them; true with an indivisible count raises,
    and so does a launch of several processes that cannot split it."""
    setting = cfg.get("parallel", {}).get("data_parallel", "auto")
    num_envs = cfg["env"]["num_envs"]
    if setting is not False and n > 1 and num_envs % n == 0:
        return n
    if setting is True and n > 1:
        raise ValueError(f"parallel.data_parallel=true but env.num_envs={num_envs} does not divide over {n} devices")
    if multi_process and n > 1:
        raise ValueError(f"a multi-process launch ({n} processes) requires the env axis to split over them, but "
                         f"env.num_envs={num_envs} does not divide over {n} (or parallel.data_parallel=false was set)")
    return 1


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker(rank: int, world: int, port: int, argv) -> None:
    os.environ.update(GEOMRL_COORDINATOR=f"localhost:{port}", GEOMRL_NUM_PROCESSES=str(world),
                      GEOMRL_PROCESS_ID=str(rank), LOCAL_RANK=str(rank))
    main(argv)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True, help="config name or path")
    ap.add_argument("--override", nargs="*", default=[], help="dot.key=value overrides")
    ap.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    ap.add_argument("--dist-backend", default=None, help="collective backend of a multi-process launch "
                                                         "(default: nccl on CUDA, gloo on the CPU)")
    args = ap.parse_args(argv)

    from ..config import load_config, trainer_from_config
    from ..parallel import DataParallel, is_main_process, local_device, maybe_initialize_distributed
    from .checkpoint import latest_step, restore_checkpoint, restore_tree
    from .logging import MetricsLogger

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.override))
    # join a multi-process launch before anything touches the card
    started_group = not dist.is_initialized() and maybe_initialize_distributed(device, args.dist_backend)
    multi = dist.is_initialized()
    if multi:
        n_devices = dist.get_world_size()
    else:
        n_devices = torch.cuda.device_count() if device.type == "cuda" and device.index is None else 1
    width = data_parallel_width(cfg, n_devices, multi)
    if width > 1 and not multi:
        # one worker per card, wired over a localhost rendezvous
        print(f"data-parallel: env axis {cfg['env']['num_envs']} over {width} cards, one worker each", flush=True)
        torch.multiprocessing.spawn(_worker, args=(width, _free_port(), sys.argv[1:] if argv is None else argv), nprocs=width)
        return None
    device = local_device(device)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)
    dp = DataParallel() if multi else None
    is_main = is_main_process()
    trainer = trainer_from_config(cfg, device=device, dp=dp)

    stamp = datetime.now().strftime("%y_%m_%d-%H_%M_%S")
    if dp is not None:
        stamp = dp.broadcast_object(stamp)  # one run dir for every rank
        if is_main:
            print(f"data-parallel: env axis {trainer.num_envs} split over {dp.world} processes "
                  f"({dp.backend}), {trainer.env.cfg.num_envs} envs each", flush=True)
    log_dir = os.path.join(cfg["logger"]["log_dir"], f"{cfg['task']}_{cfg['model']}_{cfg['algo']}_{stamp}")
    logger = MetricsLogger(log_dir, use_wandb=cfg["logger"].get("wandb", False)) if is_main else None
    if logger:
        logger.log_hparams(cfg)

    generator = torch.Generator(device=device).manual_seed(cfg["seed"])
    if dp is None:
        state = trainer.init(generator)
    else:  # the whole initial state built on every rank as one process builds it; each keeps its rows
        state = trainer.init_from(trainer_from_config(cfg, device=device), generator)
    papi_state = trainer.papi_init(state) if trainer.cfg.papi_steps else None
    start_iter = 0
    load_dir = args.resume or cfg["logger"]["checkpoint"].get("load_dir")
    if load_dir:
        step = latest_step(load_dir)
        state = restore_checkpoint(load_dir, trainer, state, step)
        start_iter = step + 1
        if is_main:
            print(f"Resumed from {load_dir} @ iteration {step}")
        if papi_state is not None:
            # without PAPI's carry a resumed run would restart at lr_scale 1
            # with an empty history
            papi_dir = load_dir.rstrip("/") + "_papi"
            if latest_step(papi_dir) is not None:
                papi_state = restore_tree(papi_dir, papi_state)
                if is_main:
                    print(f"Resumed PAPI state from {papi_dir}")
            elif is_main:
                print(f"WARNING: no PAPI state at {papi_dir}; LR anneal/history reset")

    video_cfg = None
    if cfg["env"].get("video") and is_main:
        video_cfg = {
            "interval": max(1, int(cfg["env"].get("video_interval", 50))),
            "length": int(cfg["env"].get("video_length", 0)),
            "dir": os.path.join(log_dir, cfg["env"].get("video_dir", "videos")),
        }
        os.makedirs(video_cfg["dir"], exist_ok=True)

    ckpt_cfg = cfg["logger"]["checkpoint"]
    start = time.time()
    train_loop(
        trainer, state, logger, start_iter,
        total_iterations=max(1, cfg["collector"]["total_frames"] // cfg["collector"]["frames_per_batch"]),
        save_interval=ckpt_cfg["save_interval"], save_best=ckpt_cfg["save_best"],
        max_to_keep=ckpt_cfg.get("max_to_keep", 5), log_dir=log_dir, papi_state=papi_state, is_main=is_main,
        video_cfg=video_cfg,
    )
    if is_main:
        print(f"Training took {time.time() - start:.1f}s")
    if logger:
        logger.close()
    if started_group:
        dist.destroy_process_group()
    return log_dir


def train_loop(trainer, state, logger, start_iter, total_iterations, save_interval, save_best, max_to_keep, log_dir,
               papi_state=None, is_main=True, video_cfg=None):
    """The iterations; every rank of a data-parallel run calls it, rank 0
    (`is_main`) logs, prints, writes and renders."""
    from .checkpoint import save_checkpoint, save_tree

    ckpt_dir = os.path.join(log_dir, "checkpoints")
    frames_per_batch = trainer.cfg.steps_per_batch * trainer.num_envs
    best_reward = -float("inf")

    def save(directory, step, **kw):
        save_checkpoint(directory, step, trainer, state, max_to_keep=max_to_keep, **kw)

    def save_papi(step):
        if is_main:  # PAPI's carry is replicated
            save_tree(ckpt_dir + "_papi", step, papi_state, max_to_keep=max_to_keep)

    for i in range(start_iter, total_iterations):
        t0 = time.time()
        if papi_state is not None:
            state, papi_state, metrics = trainer.train_iteration_papi(state, papi_state)
        else:
            state, metrics = trainer.train_iteration(state)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["train/iteration_time"] = time.time() - t0
        metrics["train/frames"] = (i + 1) * frames_per_batch
        if logger:
            logger.log(i, metrics)

        reward = metrics.get("train/reward", float("nan"))  # the same on every rank: it is all-reduced
        if is_main:
            print(
                f"iter {i}/{total_iterations} reward={reward:.3f} kl={metrics.get('kl', 0):.4f} "
                f"ESS={metrics.get('ESS', 0):.3f} ({metrics['train/iteration_time']:.1f}s)",
                flush=True,
            )
        if save_interval > 0 and i % save_interval == 0:
            save(ckpt_dir, i, metrics={"reward": reward})
            if papi_state is not None:
                save_papi(i)
        if save_best and reward == reward and reward > best_reward:  # NaN-safe
            best_reward = reward
            save(os.path.join(log_dir, "best"), i, metrics={"reward": reward})
        if video_cfg and i % video_cfg["interval"] == 0:
            # a deterministic rollout of env 0 with the current policy; a
            # failed recording warns and does not end the run
            try:
                from .render import record_rollout

                n_steps = video_cfg["length"] or getattr(trainer.env.cfg, "episode_length", 100)
                path = os.path.join(video_cfg["dir"], f"iter_{i:05d}.gif")
                record_rollout(trainer, state, path, n_steps=n_steps)
                print(f"recorded {path}", flush=True)
            except Exception as e:
                print(f"WARNING: video recording failed at iter {i}: {e}", flush=True)
    save(ckpt_dir, total_iterations - 1)
    if papi_state is not None:
        save_papi(total_iterations - 1)
    return state


if __name__ == "__main__":
    main()
