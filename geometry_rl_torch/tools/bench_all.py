"""The port's per-task benchmark table (port of `scripts/bench_all.py`):
env-only stepping with uniform random actions for every task, and the HEPi
collection loop of `tools.bench` for rigid_insertion, cloth_hanging (solver
mode "auto": K2's port), cloth_hanging_pallas (`use_pallas_solver=True`:
K1's port) and rope_closing, in env-steps/s.

    python -m geometry_rl_torch.tools.bench_all                   # the script's sizes, on the card
    python -m geometry_rl_torch.tools.bench_all --tiny --device cpu --tasks rigid_insertion --steps 2

Prints one line per row and writes the table to `--out` (default
`bench_all_torch.json` in the working directory). A row that fails records
its error and the table goes on, as the script's does; the exit code is then
1. `--tiny` (4 envs, latent 16, 4 orientations, one timed run), `--tasks`
and `--steps` cut size and depth. `--device` defaults to `cuda` and raises
where there is no card. Each measurement times 3 runs of `--steps` control
steps after an untimed warm-up run, each run continuing from the last one's
state (the script restarts each run from the same state).
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from .bench import bench_collection, timed

STEPS = 50
# (row, envs, env kwargs): the script's rows
TASKS = [
    ("rigid_insertion", 1024, {}),
    ("rigid_pushing", 1024, {}),
    ("rigid_sliding", 1024, {}),
    ("rigid_insertion_two_agents", 1024, {}),
    ("rope_closing", 512, {}),
    ("rope_shaping", 256, {}),
    ("cloth_hanging", 256, {}),
    ("cloth_hanging_pallas", 256, {"use_pallas_solver": True}),
]
COLLECTION_ROWS = ("rigid_insertion", "cloth_hanging", "cloth_hanging_pallas", "rope_closing")
RUNS = 3
TINY = dict(num_envs=4, latent_dim=16, num_ori=4, runs=1)


def bench_env_only(task: str, num_envs: int, kwargs: dict, steps: int = STEPS, n_runs: int = RUNS,
                   device="cuda") -> float:
    """env-steps/s of `env.step` alone, with actions uniform in [-1, 1) from a
    generator seeded 1 (the script's `PRNGKey(1)`); the env reset from seed 0."""
    from ..envs import make_env

    device = torch.device(device)
    env = make_env(task, num_envs=num_envs, device=device, **kwargs)
    state = env.reset(torch.Generator(device=device).manual_seed(0))
    generator = torch.Generator(device=device).manual_seed(1)
    shape = (num_envs, env.cfg.action_dim)

    def run(state):
        for _ in range(steps):
            state, _ = env.step(state, torch.rand(shape, generator=generator, device=device) * 2 - 1)
        return state

    dt, _ = timed(run, state, n_runs, device)
    return steps * num_envs / dt


def main(argv=None) -> int:
    rows = [name for name, _, _ in TASKS]
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tasks", nargs="+", choices=rows, default=rows, help="rows to run (default all)")
    ap.add_argument("--steps", type=int, default=STEPS, help=f"control steps per run (default {STEPS})")
    ap.add_argument("--tiny", action="store_true", help="4 envs, latent 16, 4 orientations, one timed run")
    ap.add_argument("--out", default="bench_all_torch.json", help="the table's JSON file")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..train.cli import resolve_device

    device = resolve_device(args.device)
    widths = dict(latent_dim=TINY["latent_dim"], num_ori=TINY["num_ori"]) if args.tiny else {}
    n_runs = TINY["runs"] if args.tiny else RUNS
    results = {}
    for task, num_envs, kwargs in TASKS:
        if task not in args.tasks:
            continue
        base_task, num_envs = task.replace("_pallas", ""), TINY["num_envs"] if args.tiny else num_envs
        try:
            env_rate = bench_env_only(base_task, num_envs, kwargs, args.steps, n_runs, device)
            results[task] = {"num_envs": num_envs, "env_only_steps_per_s": env_rate}
            if task in COLLECTION_ROWS:
                results[task]["collection_steps_per_s"] = bench_collection(
                    base_task, num_envs, args.steps, n_runs, device, env_kwargs=kwargs, **widths)
        except Exception as e:  # keep going; the row records the failure and the exit code reports it
            results[task] = {"error": f"{type(e).__name__}: {e}"}
        print(task, "->", json.dumps(results[task]), flush=True)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    print("wrote", args.out)
    failed = [task for task, row in results.items() if "error" in row]
    if failed:
        print(f"bench_all: {len(failed)} row(s) failed: {failed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
