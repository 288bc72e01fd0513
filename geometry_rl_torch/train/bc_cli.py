"""Behaviour-cloning entry point (port of `geometry_rl_tpu/train/bc_cli.py`).

Load (or record) a rollout dataset, fit the policy mean to the recorded
actions with minibatch Adam, evaluate in the env every few epochs, and save
the cloned policy.

    # record data with a trained checkpoint, then clone
    python -m geometry_rl_torch.train.bc_cli --config rigid_insertion_multi_hepi_trpl \\
        --checkpoint logs/.../best --record-steps 200 --epochs 50

Writes `<out-dir>/data.npz` (unless `--data` is given), `<out-dir>/cloned/`
(a checkpoint), `<out-dir>/bc_history.json` and `<out-dir>/hparams.json`, so
`python -m geometry_rl_torch.train.play --run-dir <out-dir> --checkpoint cloned`
evaluates the clone. `--device` defaults to `cuda`.
"""

from __future__ import annotations

import argparse
import json
import os

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", default=None, help="checkpoint dir for the data-collection policy")
    ap.add_argument("--data", default=None, help="existing .npz dataset (skips recording)")
    ap.add_argument("--record-steps", type=int, default=200)
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--eval-steps", type=int, default=200)
    ap.add_argument("--success-threshold", type=float, default=None,
                    help="final deterministic success-rate eval of the cloned policy at this object->target distance "
                         "(tasks exposing object_target_distance)")
    ap.add_argument("--fresh-actor", action="store_true",
                    help="reinitialise the actor after --checkpoint restore (keep the normaliser stats the dataset was "
                         "recorded with): clone the expert into a fresh policy instead of fine-tuning the expert itself")
    ap.add_argument("--out-dir", default="logs/bc")
    ap.add_argument("--override", nargs="*", default=[])
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..config import load_config, trainer_from_config
    from .bc import behavior_cloning, generate_data
    from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from .cli import parse_overrides, resolve_device

    device = resolve_device(args.device)
    cfg = load_config(args.config, parse_overrides(args.override))
    trainer = trainer_from_config(cfg, device=device)
    state = trainer.init(torch.Generator(device=device).manual_seed(cfg["seed"]))
    if args.checkpoint:
        state = restore_checkpoint(args.checkpoint, trainer, state, latest_step(args.checkpoint))
    if args.fresh_actor:
        # the actor as `init` draws it from seed + 1; the critic and the
        # state (normaliser, env) stay as restored
        critic = {k: v.clone() for k, v in trainer.critic.state_dict().items()}
        trainer.init(torch.Generator(device=device).manual_seed(cfg["seed"] + 1))
        trainer.critic.load_state_dict(critic)

    os.makedirs(args.out_dir, exist_ok=True)
    if args.data:
        data = dict(np.load(args.data))
    else:
        data_path = os.path.join(args.out_dir, "data.npz")
        data = generate_data(trainer, state, n_steps=args.record_steps, path=data_path)
        print(f"recorded {data['action'].shape[0]} transitions -> {data_path}")

    state, history = behavior_cloning(trainer, state, data, epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                                      eval_every=args.eval_every, eval_steps=args.eval_steps)
    for row in history:
        print(json.dumps(row), flush=True)

    if args.success_threshold is not None:
        succ = trainer.eval_success(state, args.eval_steps, args.success_threshold)
        summary = {
            "success_rate": float(succ["success_rate"]),
            "mean_final_distance": float(succ["mean_final_distance"]),
            "threshold": args.success_threshold,
            "transitions": int(data["action"].shape[0]),
            "epochs": args.epochs,
        }
        history.append({"final_eval": summary})
        print(json.dumps({"final_eval": summary}), flush=True)

    save_checkpoint(os.path.join(args.out_dir, "cloned"), args.epochs, trainer, state)
    with open(os.path.join(args.out_dir, "bc_history.json"), "w") as f:
        json.dump(history, f, indent=2)
    with open(os.path.join(args.out_dir, "hparams.json"), "w") as f:  # what play rebuilds the agent from
        json.dump(cfg, f, indent=2, default=str)
    print(f"saved cloned policy to {args.out_dir}/cloned")
    return history


if __name__ == "__main__":
    main()
