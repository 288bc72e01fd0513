"""Where the time of a training iteration goes, on one CUDA card.

    python -m geometry_rl_torch.train.profile [--config NAME] [--minibatches 20] [--override k=v ...]

Builds the trainer at the config's width, runs one warm-up `train_iteration`,
then prints:
  - a second iteration's seconds, collect and update apart (synchronised);
  - ms per minibatch step (loss, backward, two Adam steps), synchronised, over
    a window of `--minibatches` steps;
  - under `torch.profiler` over the same window: device kernels per minibatch,
    the device's busy and idle share of the window's wall time, the device
    kernels, device time and host time per minibatch of each part of the step
    (`PARTS`: forward, projection, backward, optimizer (gradient clip and
    Adam), and what is left: zero_grad, the loss's own ops and the logged
    gradient norm), the device and host time inside the KL projection's
    bisection (`rl.kl_bisection`), and the kernels with the most device time.
    Clipped PPO and KL-penalty PPO (`algo=ppo|kl_ppo`) have no projection:
    their projection and bisection parts count 0;
  - with `algorithm.objective.papi_steps=true`, PAPI's post-update steps as
    a part of their own: ms, device kernels and peak device memory of one
    call on a collected batch (`papi_window`);
  - under `torch.profiler`, on a trainer whose collect is `COLLECT_STEPS` (2)
    control steps long (after a warm-up collect): device kernels per control
    step, the device's busy and idle share, the device and host time under
    the env step, the policy and the critic, and the ops and kernels with
    the most device time (`collect_window`).
The parts are the program's own spans (`utils/trace.py`), recorded with
`recording()` while the profiler runs, so that each shows on the profiler's
timeline; host times are the recording's. Both windows also count the port's
own kernels per step (`PORT_KERNELS`, by name). `update_window(trainer,
state, n)` and `collect_window(trainer, state, steps)` are the windows
alone, for callers that have a trainer.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import torch

from ..utils.trace import recording

# the parts of a minibatch step, each the program's spans (`utils/trace.py`):
# "forward" is `train.policy` and `train.critic`, "projection" is
# `rl.projection` (which holds `rl.kl_bisection`), "optimizer" is
# `train.optimizer` (the gradient clip and both Adam steps), and "other" is
# what is left: zero_grad, the loss's own ops and the logged gradient norm
PARTS = ("forward", "projection", "backward", "optimizer", "other")
PART_SPANS = {"forward": ("train.policy", "train.critic"), "projection": ("rl.projection",),
              "backward": ("train.backward",), "optimizer": ("train.optimizer",)}
# the spans of a control step that the collect window reports
COLLECT_SPANS = ("envs.step", "train.policy", "train.critic")
# the length of the profiled collect, in control steps
COLLECT_STEPS = 2
# the device functions of `csrc/`, counted by name in each window
PORT_KERNELS = ("cloth_solve_kernel", "cloth_solve_env_kernel", "segment_sum_kernel")


def _profiled(fn):
    """Run `fn` under a recording of the program's spans and
    `torch.profiler`; returns (the recording, the profiler's events, the
    wall seconds, ending in a synchronize)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with recording() as rec, torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return rec, prof, wall


def _device_kernels(events):
    """The device kernels among profiler `events`, less the mirrors that the
    spans' `record_function` ranges and the optimizers' step annotation put
    on the device timeline."""
    cpu = torch.autograd.DeviceType.CPU
    annotations = {e.name for e in events if e.device_type == cpu and getattr(e, "is_user_annotation", False)}
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in annotations
            and not e.name.startswith("Optimizer.")]


def _span_intervals(events, name: str) -> List[Tuple[float, float]]:
    """The host intervals of the span `name` on the profiler's clock (us)."""
    return [(e.time_range.start, e.time_range.end) for e in events
            if e.name == name and e.device_type == torch.autograd.DeviceType.CPU]


def _port_kernels(kernels, steps: int, tag: str, per: str) -> Dict[str, float]:
    counts = {k: sum(1 for e in kernels if k in e.name) / steps for k in PORT_KERNELS}
    print(f"[profile] {tag}the port's kernels per {per}: " + ", ".join(f"{k} {v:g}" for k, v in counts.items()))
    return counts


def collect_window(trainer, state, steps: int, tag: str = "") -> Dict[str, float]:
    """Profile one collect of `trainer` (whose batch must be `steps` control
    steps) after a warm-up collect from `state`. Prints the report and
    returns its headline numbers."""
    state, _, _ = trainer._collect(state)  # warm-up
    torch.cuda.synchronize()
    rec, prof, wall = _profiled(lambda: trainer._collect(state))
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    kernels = _device_kernels(events)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    idle = 100 - 100 * busy_ms / 1e3 / wall
    print(f"[profile] {tag}collect, {trainer.num_envs} envs, {steps} control steps after a warm-up: "
          f"{1e3 * wall:.1f} ms wall, {len(kernels) / steps:.0f} device kernels per control step, device busy "
          f"{busy_ms:.1f} ms, idle {idle:.1f}% of the wall")
    totals = rec.totals()
    for label in COLLECT_SPANS:
        dev_ms = sum(e.device_time_total for e in events if e.name == label and e.device_type == cpu) / 1e3
        calls, host_s, _ = totals.get(label, (0, 0.0, 0.0))
        print(f"[profile] {tag}  {label}: {calls // steps} calls per control step, {dev_ms:.2f} ms of device "
              f"time ({100 * dev_ms / max(busy_ms, 1e-9):.1f}% of busy), {1e3 * host_s:.1f} ms of host time")
    annotations = {e.name for e in events if e.device_type == cpu and getattr(e, "is_user_annotation", False)}

    def self_device_us(avg):
        return getattr(avg, "self_device_time_total", None) or getattr(avg, "self_cuda_time_total", 0.0)
    ops = sorted((a for a in prof.key_averages() if a.device_type == cpu and a.key not in annotations),
                 key=lambda a: -self_device_us(a))
    for a in ops[:5]:
        print(f"[profile] {tag}  op {a.key}: {self_device_us(a) / 1e3:.2f} ms of device time, {a.count // steps} "
              f"calls per control step")
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:5]:
        print(f"[profile] {tag}  kernel {t / 1e3:8.2f} ms {c // steps:6d}x per control step  {name[:100]}")
    port = _port_kernels(kernels, steps, tag, "control step")
    return {"kernels_per_control_step": len(kernels) / steps, "idle_percent": idle, "busy_ms": busy_ms,
            **{f"{k}_per_control_step": v for k, v in port.items()}}


def update_window(trainer, state, minibatches: int, tag: str = "") -> Dict[str, float]:
    """Time and profile `minibatches` minibatch steps on the batch collected
    from `state` (which must hold at least that many minibatches). Prints the
    report and returns its headline numbers."""
    state, batch, _ = trainer._collect(state)
    data = trainer._update_data(state, batch)
    idx = trainer._permutation(state.generator, data["action"].shape[0])[:minibatches]
    mbs = [trainer._minibatch(data, i) for i in idx]

    def window():
        kl_beta = state.kl_beta
        for mb in mbs:
            _, kl_beta = trainer._minibatch_step(state, mb, state.num_updates, kl_beta)

    window()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    window()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = len(mbs)
    step_ms = 1e3 * wall / n
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[profile] {tag}minibatch step: {step_ms:.3f} ms (synchronised, mean of {n}); peak device memory over the "
          f"window {peak_gib:.3f} GiB")

    rec, prof, wall = _profiled(window)
    events = prof.events()
    kernels = _device_kernels(events)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    per_mb = len(kernels) / n
    idle = 100 - 100 * busy_us / 1e6 / wall
    print(f"[profile] {tag}profiled window: {1e3 * wall:.1f} ms wall for {n} minibatches, {per_mb:.0f} device "
          f"kernels per minibatch, device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
          f"(idle {idle:.1f}%)")

    # each device kernel belongs to the CPU op that launched it; an op belongs
    # to the span whose host interval holds its start (the backward's ops run
    # on autograd's thread while the main thread waits inside its span); host
    # time is the recording's
    ops = [(e.time_range.start, len(e.kernels), sum(k.duration for k in e.kernels))
           for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.kernels]
    totals = rec.totals()

    def inside(*names):
        count = dev = host = 0.0
        for name in names:
            spans = _span_intervals(events, name)
            for start, k, d in ops:
                if any(a <= start < b for a, b in spans):
                    count, dev = count + k, dev + d
            host += 1e6 * totals.get(name, (0, 0.0, 0.0))[1]
        return count, dev, host

    parts = {label: inside(*names) for label, names in PART_SPANS.items()}
    total = (sum(k for _, k, _ in ops), sum(d for _, _, d in ops), 1e6 * wall)
    parts["other"] = tuple(t - sum(v[i] for v in parts.values()) for i, t in enumerate(total))
    for label in PARTS:
        k, d, h = parts[label]
        print(f"[profile] {tag}  {label:10s} {k / n:7.0f} device kernels, {d / 1e3 / n:7.3f} ms of device time, "
              f"{h / 1e3 / n:7.3f} ms of host time per minibatch")
    k, d, h = inside("rl.kl_bisection")
    print(f"[profile] {tag}rl.kl_bisection: {k / n:.0f} device kernels per minibatch, {d / 1e3:.2f} ms of device "
          f"time = {100 * d / max(busy_us, 1):.1f}% of the busy time; {h / 1e3:.1f} ms of host time = "
          f"{100 * h / 1e6 / wall:.1f}% of the window's wall time")
    by_name = {}
    for e in kernels:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    for name, (c, t) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"[profile] {tag}  {t / 1e3:8.2f} ms {c:6d}x  {name[:110]}")
    port = _port_kernels(kernels, n, tag, "minibatch")
    return {"step_ms": step_ms, "kernels_per_minibatch": per_mb, "idle_percent": idle, "peak_gib": peak_gib,
            **{f"kernels_{label}": parts[label][0] / n for label in PARTS},
            **{f"{k}_per_minibatch": v for k, v in port.items()}}


def papi_window(trainer, state, tag: str = "") -> Dict[str, float]:
    """Time and profile one call of PAPI's post-update steps on the batch
    collected from `state` (after a warm-up call); prints ms, device kernels,
    peak device memory and the backtracks taken, and returns them."""
    papi_state = trainer.papi_init(state)
    state, batch, _ = trainer._collect(state)
    trainer._papi_steps(state, batch, papi_state)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    _, metrics = trainer._papi_steps(state, batch, papi_state)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        trainer._papi_steps(state, batch, papi_state)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    n_samples = batch.action.shape[0] * batch.action.shape[1]
    print(f"[profile] {tag}papi steps: {ms:.1f} ms (synchronised) over {n_samples} samples, {len(kernels)} device "
          f"kernels, {metrics['papi/n_backtracks'].item():.0f} backtracks, {trainer.cfg.papi_iters} iterations; peak "
          f"device memory {peak_gib:.3f} GiB")
    return {"papi_ms": ms, "papi_kernels": float(len(kernels)), "papi_peak_gib": peak_gib,
            "papi_n_backtracks": metrics["papi/n_backtracks"].item()}


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
    update_window(trainer, state, args.minibatches)
    if trainer.cfg.papi_steps:
        papi_window(trainer, state)
    del trainer, state
    torch.cuda.empty_cache()
    cfg["collector"]["frames_per_batch"] = COLLECT_STEPS * cfg["env"]["num_envs"]
    short = trainer_from_config(cfg, device=dev)
    collect_window(short, short.init(torch.Generator(device=dev).manual_seed(cfg["seed"])), COLLECT_STEPS)


if __name__ == "__main__":
    main()
