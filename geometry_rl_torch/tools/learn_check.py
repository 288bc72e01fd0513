"""Learning sanity check (port of `scripts/learn_check.py`): train a task
briefly and report the episode-reward trend. Not a unit test (it takes
minutes at the default size on the card).

    python -m geometry_rl_torch.tools.learn_check --iterations 10
    python -m geometry_rl_torch.tools.learn_check --device cpu --num-envs 4 --iterations 2 --steps-per-batch 4 --mini-batch 8

Prints one JSON row per iteration, then a `SUMMARY` line (with the final
deterministic eval's success rate on rigid tasks); `--out` gets the history
and the summary, `--save-dir` a checkpoint of the final state. A failure of
the final eval is raised (the JAX script writes it into the summary as
`eval_error`). `--device` defaults to `cuda` and raises where there is no
card; `--seed` seeds the run's generator.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

ROW_METRICS = ("kl", "ESS", "entropy", "loss_critic", "beta")  # those the algorithm reports


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="rigid_insertion")
    ap.add_argument("--model", default="hepi")
    ap.add_argument("--algo", default="trpl")
    ap.add_argument("--num-envs", type=int, default=512)
    ap.add_argument("--iterations", type=int, default=40)
    ap.add_argument("--steps-per-batch", type=int, default=100)
    ap.add_argument("--mini-batch", type=int, default=1000)
    ap.add_argument("--out", default=None)
    ap.add_argument("--save-dir", default=None, help="checkpoint the final state here")
    ap.add_argument("--success-threshold", type=float, default=0.1)
    ap.add_argument("--env-kw", nargs="*", default=[], help="extra env kwargs key=value (floats)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..train import TrainConfig
    from ..train.builders import build_agent
    from ..train.cli import resolve_device

    device = resolve_device(args.device)
    trainer = build_agent(
        task=args.task,
        model=args.model,
        num_envs=args.num_envs,
        algo=args.algo,
        latent_dim=64,
        num_ori=16,
        dtype=torch.bfloat16,
        train_cfg=TrainConfig(
            algo=args.algo,
            steps_per_batch=args.steps_per_batch,
            ppo_epochs=5,
            mini_batch_size=args.mini_batch,
            total_iterations=args.iterations,
        ),
        env_kwargs={"warmup_steps": 0, **{k: float(v) for k, v in (s.split("=", 1) for s in args.env_kw)}},
        device=device,
    )
    state = trainer.init(torch.Generator(device=device).manual_seed(args.seed))

    history = []
    t0 = time.time()
    for i in range(args.iterations):
        it_t = time.time()
        state, metrics = trainer.train_iteration(state)
        keys = ["train/reward", *(k for k in ROW_METRICS if k in metrics), "train/explained_variance"]
        values = dict(zip(keys, torch.stack([metrics[k].float().to(device) for k in keys]).tolist()))  # one host read
        reward = values["train/reward"]
        history.append(reward)
        print(
            json.dumps(
                {
                    "iter": i,
                    "reward": round(reward, 4),
                    **{k: round(values[k], 6) for k in ROW_METRICS if k in values},
                    "explained_var": round(values["train/explained_variance"], 4),
                    "it_time": round(time.time() - it_t, 2),
                }
            ),
            flush=True,
        )

    first = sum(history[:5]) / 5
    last = sum(history[-5:]) / 5
    summary = {
        "task": args.task,
        "model": args.model,
        "first5_mean_reward": round(first, 3),
        "last5_mean_reward": round(last, 3),
        "improved": last > first,
        "total_time_s": round(time.time() - t0, 1),
        "env_steps": args.iterations * args.steps_per_batch * args.num_envs,
    }
    if args.task.startswith("rigid"):
        ev = trainer.eval_success(state, n_steps=trainer.env.cfg.episode_length * 2, threshold=args.success_threshold)
        success, distance = torch.stack([ev["success_rate"], ev["mean_final_distance"]]).tolist()
        summary["eval_success_rate"] = round(success, 4)
        summary["eval_mean_final_distance"] = round(distance, 4)
    print("SUMMARY " + json.dumps(summary), flush=True)
    if args.save_dir:
        from ..train.checkpoint import save_checkpoint

        save_checkpoint(args.save_dir, args.iterations, trainer, state)
        print(f"checkpointed -> {args.save_dir}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": history, **summary}, f)
    return history, summary


if __name__ == "__main__":
    main()
