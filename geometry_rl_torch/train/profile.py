"""Where the time of a training iteration goes, on one CUDA card.

    python -m geometry_rl_torch.train.profile [--config NAME] [--minibatches 20] [--override k=v ...]

Builds the trainer at the config's width, runs one warm-up `train_iteration`,
then prints:
  - a second iteration's seconds, collect and update apart (synchronised);
  - ms per minibatch step (loss, backward, two Adam steps), synchronised, over
    a window of `--minibatches` steps;
  - under `torch.profiler` over the same window: device kernels per minibatch,
    the device's busy and idle share of the window's wall time, the device
    and host time inside the KL projection's bisection (`kl_bisection`
    range), and the kernels with the most device time.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="cloth_hanging_multi_hepi_trpl")
    ap.add_argument("--minibatches", type=int, default=20)
    ap.add_argument("--override", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the profile measures a CUDA card; torch.cuda.is_available() is False")

    from ..config import load_config, trainer_from_config
    from .cli import parse_overrides

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = load_config(args.config, parse_overrides(args.override))
    trainer = trainer_from_config(cfg, device=dev)
    state = trainer.init(torch.Generator(device=dev).manual_seed(cfg["seed"]))
    state, _ = trainer.train_iteration(state)  # warm-up
    state, metrics = trainer.train_iteration(state)
    print(f"[profile] {args.config}: train_iteration collect {float(metrics['train/collect_time']):.3f} s, "
          f"update {float(metrics['train/update_time']):.3f} s "
          f"({trainer.cfg.ppo_epochs} epochs x {trainer.num_minibatches} minibatches of {trainer.mini_batch_size})")

    state, batch, _ = trainer._collect(state)
    data = trainer._update_data(state, batch)
    idx = trainer._permutation(state.generator, data["action"].shape[0])[: args.minibatches]
    mbs = [{k: ({g: x[i] for g, x in v.items()} if k == "tobs" else v[i]) for k, v in data.items()} for i in idx]

    def window():
        for mb in mbs:
            trainer._minibatch_step(state, mb, state.num_updates)

    window()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(mbs)
    print(f"[profile] minibatch step: {1e3 * wall / n:.3f} ms (synchronised, mean of {n})")

    # the bisection gets its range only here, so the training loop pays no
    # host time for it
    from ..rl.projections import kl

    solve_eta = kl._solve_eta

    def ranged_solve_eta(*a):
        with torch.profiler.record_function("kl_bisection"):
            return solve_eta(*a)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    kl._solve_eta = ranged_solve_eta
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        kl._solve_eta = solve_eta
    events = prof.events()
    # device-side events other than the ranges that record_function and the
    # optimizer's step annotation mirror onto the device timeline
    annotations = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU
                   and getattr(e, "is_user_annotation", False)} | {"kl_bisection"}
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.name not in annotations
               and not e.name.startswith("Optimizer.")]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    bisect = [e for e in events if e.name == "kl_bisection" and e.device_type == torch.autograd.DeviceType.CPU]
    bisect_us = sum(e.device_time_total for e in bisect)
    bisect_host_us = sum(e.time_range.elapsed_us() for e in bisect)
    print(f"[profile] profiled window: {1e3 * wall:.1f} ms wall for {n} minibatches, {len(kernels) / n:.0f} device "
          f"kernels per minibatch, device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
          f"(idle {100 - 100 * busy_us / 1e6 / wall:.1f}%)")
    print(f"[profile] kl_bisection: {bisect_us / 1e3:.2f} ms of device time = {100 * bisect_us / max(busy_us, 1):.1f}% "
          f"of the busy time; {bisect_host_us / 1e3:.1f} ms of host time = {100 * bisect_host_us / 1e6 / wall:.1f}% "
          f"of the window's wall time")
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile]   {t / 1e3:8.2f} ms {c:6d}x  {name[:110]}")


if __name__ == "__main__":
    main()
