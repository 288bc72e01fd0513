"""Per-shape evaluation breakdown for multi-asset rigid tasks (port of
`scripts/eval_breakdown.py`).

Loads a trained run's checkpoint, rolls the deterministic policy, and reports
the final object->target distance and success rate per peg shape (the
multi-asset axis the paper evaluates). Tasks without shapes report `overall`
only.

    python -m geometry_rl_torch.tools.eval_breakdown --run-dir logs/<run> [--checkpoint best] --device cpu

`--device` defaults to `cuda` and raises where there is no card. The
rollout stays on the device and is read to the host once.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

ROLLOUT_SEED = 42


def breakdown(dones: np.ndarray, dists: np.ndarray, shape_ids: Optional[np.ndarray], names: Sequence[str],
              threshold: float) -> Dict:
    """`{"overall": ..., "per_shape": ...}` of a rollout's `dones` and
    `object_target_distance`s `[T, B]`: the distances where an episode ends,
    per shape of `shape_ids` `[B]` (None: `overall` only); a shape with no
    finished episode is left out."""
    done = dones.astype(bool)
    final_d = dists[done]
    report = {}
    if shape_ids is not None:
        final_shape = np.broadcast_to(shape_ids, dones.shape)[done]
        for s, name in enumerate(names):
            sel = final_shape == s
            if sel.sum() == 0:
                continue
            d = final_d[sel]
            report[name] = {
                "episodes": int(sel.sum()),
                "mean_final_distance": round(float(d.mean()), 4),
                "success_rate": round(float((d < threshold).mean()), 4),
            }
    overall = {
        "episodes": int(done.sum()),
        "mean_final_distance": round(float(final_d.mean()), 4),
        "success_rate": round(float((final_d < threshold).mean()), 4),
    }
    return {"overall": overall, "per_shape": report}


@torch.no_grad()
def rollout(trainer, state, env_state, n_steps: int):
    """(dones, object_target_distances) `[n_steps, B]` on the host: the
    deterministic policy (the mean, on the observation normalised with the
    state's frozen statistics) from `env_state`."""
    from ..rl.obs_pipeline import obs_norm_step

    env = trainer.env
    obs = env.observe(env_state)
    dones, dists = [], []
    for _ in range(n_steps):
        _, tobs = obs_norm_step(state.norm, obs, update=False)
        env_state, ts = env.step(env_state, trainer._policy_dist(tobs).mean)
        dones.append(ts.done)
        dists.append(ts.info["object_target_distance"])
        obs = ts.obs
    dists = torch.stack(dists)
    host = torch.stack([torch.stack(dones).to(dists.dtype), dists]).cpu().numpy()  # the one host read
    return host[0].astype(bool), host[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--run-dir", required=True)
    ap.add_argument("--checkpoint", default="best")
    ap.add_argument("--episodes", type=int, default=3, help="episodes per env")
    ap.add_argument("--threshold", type=float, default=0.1)
    ap.add_argument("--override", nargs="*", default=[], help="dot.key=value config overrides (e.g. env.kwargs.hole_split=test)")
    ap.add_argument("--out", default="eval_breakdown.json")
    ap.add_argument("--save-distances", action="store_true",
                    help="also dump per-episode final distances + shape names into the json "
                         "(post-hoc success-threshold sweeps / per-shape histograms without re-rolling)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..config import _merge, load_config, trainer_from_config
    from ..train.checkpoint import latest_step, restore_checkpoint
    from ..train.cli import parse_overrides, resolve_device

    device = resolve_device(args.device)
    with open(os.path.join(args.run_dir, "hparams.json")) as f:
        cfg = load_config(None, json.load(f))
    if args.override:
        cfg = _merge(cfg, parse_overrides(args.override))
    trainer = trainer_from_config(cfg, device=device)
    env = trainer.env

    ckpt = os.path.join(args.run_dir, args.checkpoint)
    state = trainer.init(torch.Generator(device=device).manual_seed(0))
    state = restore_checkpoint(ckpt, trainer, state, latest_step(ckpt))

    env_state = env.reset(torch.Generator(device=device).manual_seed(ROLLOUT_SEED))
    dones, dists = rollout(trainer, state, env_state, env.cfg.episode_length * args.episodes)

    shape_ids = env.shape_ids.cpu().numpy() if hasattr(env, "shape_ids") else None
    names = env.shape_set.names if shape_ids is not None else ()
    report = breakdown(dones, dists, shape_ids, names, args.threshold)
    print(json.dumps(report, indent=2))
    payload = dict(report)
    if args.save_distances:
        done = dones.astype(bool)
        payload["final_distances"] = [round(float(d), 5) for d in dists[done]]
        if shape_ids is not None:
            payload["final_shapes"] = [names[int(s)] for s in np.broadcast_to(shape_ids, dones.shape)[done]]
    # Paths with a directory component are taken as given (relative to cwd);
    # bare filenames land inside the run dir.
    out = args.out if os.sep in args.out else os.path.join(args.run_dir, args.out)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(payload, f, indent=2)
    print("wrote", out)
    return report


if __name__ == "__main__":
    main()
