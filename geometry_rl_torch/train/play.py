"""Checkpoint evaluation (port of `geometry_rl_tpu/train/play.py`).

Rebuild the agent from the run's saved hparams, restore checkpoints (the
normaliser travels inside the train state), roll out the deterministic or
stochastic policy, and write per-checkpoint mean episode returns (and
success rates) to `<run>/eval.json`.

    python -m geometry_rl_torch.train.play --run-dir logs/geometry_rl_tpu/<run> --success-threshold 0.1

`--device` defaults to `cuda`; `--record DIR` renders a GIF of each
evaluated checkpoint's rollout into DIR (`train/render.py`, matplotlib).
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import torch


def find_latest_run(log_root: str, prefix: str) -> str:
    """The last run dir (by name, which ends in the start time) under
    `log_root` whose name starts with `prefix`."""
    candidates = sorted(glob.glob(os.path.join(log_root, f"{prefix}*")))
    if not candidates:
        raise FileNotFoundError(f"no runs matching {prefix} under {log_root}")
    return candidates[-1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-dir", required=True, help="training run dir (contains hparams.json)")
    ap.add_argument("--checkpoint", default="best", help="'best', 'checkpoints', or a dir under the run")
    ap.add_argument("--all-checkpoints", action="store_true",
                    help="evaluate every saved checkpoint of the run (interval saves + best)")
    ap.add_argument("--episodes-steps", type=int, default=400, help="eval rollout length")
    ap.add_argument("--eval-type", default="mode", choices=["mode", "random"])
    ap.add_argument("--num-envs", type=int, default=None, help="override eval env count")
    ap.add_argument("--success-threshold", type=float, default=None,
                    help="also report the success rate at this object->target distance")
    ap.add_argument("--record", default=None, metavar="DIR", help="render a rollout GIF per evaluated checkpoint into DIR")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..config import load_config, trainer_from_config
    from .checkpoint import checkpoint_steps, restore_checkpoint
    from .cli import resolve_device
    from .ppo import TrainState

    device = resolve_device(args.device)
    with open(os.path.join(args.run_dir, "hparams.json")) as f:
        cfg = json.load(f)
    trained_num_envs = cfg["env"]["num_envs"]
    if args.num_envs:
        cfg["env"]["num_envs"] = args.num_envs
    cfg = load_config(None, cfg)
    trainer = trainer_from_config(cfg, device=device)

    # with another env count the env-sized leaves (env_state, obs) do not
    # fit; the eval resets the env anyway, so restore everything else
    fields = None
    if args.num_envs and args.num_envs != trained_num_envs:
        fields = tuple(f for f in TrainState._fields if f not in ("env_state", "obs"))
    template = trainer.init(torch.Generator(device=device).manual_seed(0))

    if args.all_checkpoints:
        roots = [(os.path.join(args.run_dir, n), n) for n in ("checkpoints", "best") if os.path.isdir(os.path.join(args.run_dir, n))]
    else:
        roots = [(os.path.join(args.run_dir, args.checkpoint), args.checkpoint)]

    results = {}
    deterministic = args.eval_type == "mode"
    for ckpt_root, label in roots:
        steps = checkpoint_steps(ckpt_root)
        if not steps and not args.all_checkpoints:
            raise FileNotFoundError(f"no checkpoints under {ckpt_root}")
        for step in steps:
            state = restore_checkpoint(ckpt_root, trainer, template, step, fields=fields)
            entry = {"reward": float(trainer.eval_rollout(state, n_steps=args.episodes_steps, deterministic=deterministic))}
            if args.success_threshold is not None:
                succ = trainer.eval_success(state, args.episodes_steps, args.success_threshold, deterministic)
                entry["success_rate"] = float(succ["success_rate"])
                entry["mean_final_distance"] = float(succ["mean_final_distance"])
            key = str(step) if label == "checkpoints" else f"{label}/{step}"
            results[key] = entry
            if args.record:
                from .render import record_rollout

                os.makedirs(args.record, exist_ok=True)
                gif = os.path.join(args.record, f"{key.replace('/', '_')}.gif")
                record_rollout(trainer, state, gif, n_steps=args.episodes_steps, deterministic=deterministic)
                entry["video"] = gif
            extra = f" success {entry['success_rate']:.3f}" if "success_rate" in entry else ""
            print(f"checkpoint {key}: mean episode reward {entry['reward']:.3f}{extra}", flush=True)
    if not results:
        raise FileNotFoundError(f"no checkpoints found under {args.run_dir}")

    out = os.path.join(args.run_dir, "eval.json")
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(f"wrote {out}")
    return results


if __name__ == "__main__":
    main()
