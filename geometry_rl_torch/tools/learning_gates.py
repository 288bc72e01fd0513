"""Short learning checks of the port against the JAX package's recorded runs.

Trains a shared config for 10 iterations through the training CLI
(`train/cli.py`) and holds its `train/reward` against the curves of the same
config that the JAX package recorded in `docs/runs/<run>/metrics.jsonl`
(rows by their `step`, as the files write it). The recorded runs are read
from the source checkout this module lies in, so the tool runs only there.

- level: the mean of steps 7-9 lies in the recorded runs' range widened by
  its own width on each side (only with more than one recorded run: one run
  gives no spread);
- gain: that mean less the run's own step 0 is at least half the smallest
  recorded gain.

The port's RNG differs from JAX's, so the check is a band, not a curve.
`kl`, `ESS`, `entropy` and `train/explained_variance` at the first and last
step are printed beside the recorded runs'. The untrained policy's first
collect is then made again from the config's seed, as the run made it: its
`train/reward` (the run's step 0), mean per-step reward and mean
|policy mean| say where the gain starts from. With `--breakdown-episodes N`
the last checkpoint then goes through `tools.eval_breakdown`.

    python -m geometry_rl_torch.tools.learning_gates rigid_insertion --log-dir logs/learning --breakdown-episodes 1
    python -m geometry_rl_torch.tools.learning_gates rope_closing --log-dir logs/learning

Exits 1 when a gate fails. `--device` defaults to `cuda`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from typing import Dict, List, NamedTuple, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RUNS_DIR = os.path.join(REPO, "docs", "runs")
SHOWN = ("kl", "ESS", "entropy", "train/explained_variance")
ITERATIONS = 10  # the recorded runs' steps 0-9, which the gates are defined on
WINDOW = 3  # the last steps whose mean is held


class Case(NamedTuple):
    config: str
    overrides: tuple  # those of the recorded runs' hparams.json
    runs: tuple  # docs/runs/<run> of the same config


CASES = {
    "rigid_insertion": Case(
        "rigid_insertion_multi_hepi_trpl",
        ("env.num_envs=1024", "env.kwargs.warmup_steps=0", "collector.frames_per_batch=102400"),
        ("r5_hepi_insertion", "r8_insertion_seed1", "r8_insertion_seed2"),
    ),
    "rope_closing": Case("rope_closing_hepi_trpl", (), ("r8_rope_closing",)),
}


def read_metrics(path: str) -> Dict[int, dict]:
    """metrics.jsonl rows by their `step`."""
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return {int(r["step"]): r for r in rows}


def curve_stats(rows: Dict[int, dict], iterations: int) -> dict:
    """Step 0's reward, the mean of the last `WINDOW` of `iterations` steps,
    and the gain between them."""
    first = rows[0]["train/reward"]
    last = sum(rows[s]["train/reward"] for s in range(iterations - WINDOW, iterations)) / WINDOW
    return {"step0": first, "last_mean": last, "gain": last - first}


def gates(port: dict, refs: Sequence[dict]) -> dict:
    """The level band (more than one recorded run) and the gain floor, each
    with its outcome."""
    out = {}
    gains = [r["gain"] for r in refs]
    out["gain"] = {"min": 0.5 * min(gains), "value": port["gain"], "ok": port["gain"] >= 0.5 * min(gains)}
    if len(refs) > 1:
        lo, hi = min(r["last_mean"] for r in refs), max(r["last_mean"] for r in refs)
        band = (lo - (hi - lo), hi + (hi - lo))
        out["level"] = {"band": band, "value": port["last_mean"], "ok": band[0] <= port["last_mean"] <= band[1]}
    return out


def step0_collect(cfg: dict, device) -> dict:
    """The untrained policy's first collect as the CLI's one-process run
    makes it (the same trainer, initialised from the config's seed):
    `train/reward`, the mean per-step reward and the mean |policy mean|."""
    import torch

    from ..config import trainer_from_config

    trainer = trainer_from_config(cfg, device=device)
    _, batch, stats = trainer._collect(trainer.init(torch.Generator(device=device).manual_seed(cfg["seed"])))
    values = torch.stack([stats["train/reward"], batch.reward.float().mean(), batch.mean.float().abs().mean()]).tolist()
    return dict(zip(("train/reward", "step_reward_mean", "policy_mean_abs"), values))


def card() -> str:
    """`name, power.limit` of the card, as nvidia-smi gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("case", choices=sorted(CASES))
    ap.add_argument("--log-dir", default="logs/learning")
    ap.add_argument("--breakdown-episodes", type=int, default=0, help="eval_breakdown episodes on the last checkpoint (0: none)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..train import cli

    case = CASES[args.case]
    if args.device.startswith("cuda"):
        print(f"card: {card()}", flush=True)
    cfg = load_config(case.config, cli.parse_overrides(case.overrides))
    overrides = (*case.overrides, f"collector.total_frames={ITERATIONS * cfg['collector']['frames_per_batch']}",
                 f"logger.log_dir={args.log_dir}")
    t0 = time.time()
    run = cli.main(["--config", case.config, "--device", args.device, "--override", *overrides])
    seconds = time.time() - t0
    rows = read_metrics(os.path.join(run, "metrics.jsonl"))
    refs = {r: read_metrics(os.path.join(RUNS_DIR, r, "metrics.jsonl")) for r in case.runs}
    port = curve_stats(rows, ITERATIONS)
    ref_stats = [curve_stats(r, ITERATIONS) for r in refs.values()]
    result = gates(port, ref_stats)

    steps = (0, ITERATIONS - 1)
    table: List[str] = [f"{'run':22s} {'step0':>9s} {'mean ' + f'{steps[1] - WINDOW + 1}-{steps[1]}':>10s} {'gain':>8s}  "
                        + "  ".join(f"{k.split('/')[-1]}@{s}" for s in steps for k in SHOWN)]
    for name, stats, r in [("port", port, rows)] + [(n, s, refs[n]) for n, s in zip(case.runs, ref_stats)]:
        shown = "  ".join(f"{r[s].get(k, float('nan')):.4g}" for s in steps for k in SHOWN)
        table.append(f"{name:22s} {stats['step0']:9.2f} {stats['last_mean']:10.2f} {stats['gain']:8.2f}  {shown}")
    print("\n".join(table))
    for name, g in result.items():
        print(f"gate {name}: {json.dumps(g)} -> {'PASS' if g['ok'] else 'FAIL'}", flush=True)
    report = {"case": args.case, "run": run, "seconds": seconds, "port": port,
              "refs": dict(zip(case.runs, ref_stats)), "gates": result}
    if args.device.startswith("cuda"):
        report["card"] = card()
    cfg = load_config(case.config, cli.parse_overrides(overrides))
    report["step0_collect"] = step0_collect(cfg, cli.resolve_device(args.device))
    print(f"step-0 collect from seed {cfg['seed']}: {json.dumps(report['step0_collect'])}", flush=True)
    if args.breakdown_episodes:
        from . import eval_breakdown

        t1 = time.time()
        report["breakdown"] = eval_breakdown.main(["--run-dir", run, "--checkpoint", "checkpoints",
                                                   "--episodes", str(args.breakdown_episodes), "--device", args.device])
        report["breakdown_seconds"] = time.time() - t1
    print(f"{args.case}: {ITERATIONS} iterations in {seconds:.1f} s", flush=True)
    with open(os.path.join(run, "learning_gates.json"), "w") as f:
        json.dump(report, f, indent=2)
    print("LEARNING " + json.dumps(report), flush=True)
    return 0 if all(g["ok"] for g in result.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
