"""Env smoke check (port of `scripts/smoke_env.py`): build a task env, print
its observation spec group by group, take random steps.

    python -m geometry_rl_torch.tools.smoke_env --task rigid_insertion --num-envs 4 --device cpu

`--device` defaults to `cuda` and raises where there is no card. The
actions are uniform in [-1, 1) from a `torch.Generator` seeded with 0,
as the JAX script's `PRNGKey(0)`.
"""

from __future__ import annotations

import argparse

import torch

from ..envs import ROPE_TASKS, TASK_REGISTRY

TASKS = tuple(sorted(TASK_REGISTRY)) + tuple(sorted(ROPE_TASKS)) + ("cloth_hanging",)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--task", default="rigid_insertion", choices=TASKS)
    ap.add_argument("--num-envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from ..envs import make_env
    from ..train.cli import resolve_device

    device = resolve_device(args.device)
    env = make_env(args.task, num_envs=args.num_envs, device=device)
    spec = env.obs_spec
    print(f"task={args.task} num_envs={args.num_envs} action_dim={env.cfg.action_dim}")
    print("obs spec:")
    for group in spec.names:
        terms = ", ".join(f"{n}[{d}]" for n, d in zip(spec.names[group], spec.dims[group]))
        print(f"  {group:18s} ({spec.group_dim(group):5d}): {terms}")

    generator = torch.Generator(device=device).manual_seed(0)
    state = env.reset(generator)
    for t in range(args.steps):
        action = torch.rand((args.num_envs, env.cfg.action_dim), generator=generator, device=device) * 2 - 1
        state, ts = env.step(state, action)
        # one host read per step
        reward, done, finite = torch.stack([
            ts.reward.mean(), ts.done.sum().float(),
            torch.stack([torch.isfinite(v).all() for v in ts.obs.values()]).all().float(),
        ]).tolist()
        print(f"step {t}: reward mean {reward:+.4f} done {int(done)}/{args.num_envs} obs finite {bool(finite)}")
    print("OK")
    return env, state, ts


if __name__ == "__main__":
    main()
