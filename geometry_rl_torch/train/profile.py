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
    (forward, projection, the rest of the loss, backward, gradient clip,
    Adam, and what is left: zero_grad and the logged gradient norm), the
    device and host time inside the KL projection's bisection
    (`kl_bisection` range), and the kernels with the most device time.
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
Both windows also count the port's own kernels per step (`PORT_KERNELS`,
by name). `update_window(trainer, state, n)` and `collect_window(trainer,
state, steps)` are the windows alone, for callers that have a trainer.
It needs a card and raises without one.
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import torch

# the parts of a minibatch step, in the order they run; "clip" is
# `_optimizer_step` less the optimizers' own `step` ("adam"), "loss" is
# `_minibatch_loss` less its forwards and its projection
PARTS = ("forward", "projection", "loss", "backward", "clip", "adam", "other")
# the length of the profiled collect, in control steps
COLLECT_STEPS = 2
# the device functions of `csrc/`, counted by name in each window
PORT_KERNELS = ("cloth_solve_kernel", "cloth_solve_env_kernel", "segment_sum_kernel")


class _RangedProjection:
    """The trainer's projection layer with its call under a profiler range."""

    def __init__(self, projection):
        self._projection = projection

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function("projection"):
            return self._projection(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._projection, name)


def _ranged(fn, label):
    def ranged(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return ranged


def _device_kernels(events, annotations):
    """The device kernels among profiler `events`, less the ranges that
    `record_function` and the optimizers' step annotation mirror onto the
    device timeline."""
    return [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and e.name not in annotations
            and not e.name.startswith("Optimizer.")]


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
    ranges = {"env.step": (trainer.env, "step"), "policy": (trainer, "_policy_dist"), "critic": (trainer, "_value")}
    for label, (obj, attr) in ranges.items():
        setattr(obj, attr, _ranged(getattr(obj, attr), label))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            trainer._collect(state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for obj, attr in ranges.values():
            delattr(obj, attr)
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    annotations = {e.name for e in events if e.device_type == cpu and getattr(e, "is_user_annotation", False)}
    kernels = _device_kernels(events, annotations | set(ranges))
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    idle = 100 - 100 * busy_ms / 1e3 / wall
    print(f"[profile] {tag}collect, {trainer.num_envs} envs, {steps} control steps after a warm-up: "
          f"{1e3 * wall:.1f} ms wall, {len(kernels) / steps:.0f} device kernels per control step, device busy "
          f"{busy_ms:.1f} ms, idle {idle:.1f}% of the wall")
    for label in ranges:
        spans = [e for e in events if e.name == label and e.device_type == cpu]
        dev_ms = sum(e.device_time_total for e in spans) / 1e3
        host_ms = sum(e.time_range.elapsed_us() for e in spans) / 1e3
        print(f"[profile] {tag}  {label}: {len(spans) // steps} calls per control step, {dev_ms:.2f} ms of device "
              f"time ({100 * dev_ms / max(busy_ms, 1e-9):.1f}% of busy), {host_ms:.1f} ms of host time")

    def self_device_us(avg):
        return getattr(avg, "self_device_time_total", None) or getattr(avg, "self_cuda_time_total", 0.0)
    ops = sorted((a for a in prof.key_averages() if a.device_type == cpu and a.key not in annotations | set(ranges)),
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
    from ..rl.projections import kl

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

    # the ranges exist only here, so the training loop pays no host time for them
    patches = [(kl, "_solve_eta", _ranged(kl._solve_eta, "kl_bisection")),
               (trainer, "_policy_dist", _ranged(trainer._policy_dist, "forward")),
               (trainer, "_value", _ranged(trainer._value, "forward")),
               (trainer, "_minibatch_loss", _ranged(trainer._minibatch_loss, "minibatch_loss")),
               (trainer, "_optimizer_step", _ranged(trainer._optimizer_step, "optimizer_step")),
               (trainer, "projection", _RangedProjection(trainer.projection)),
               (torch.Tensor, "backward", _ranged(torch.Tensor.backward, "backward")),
               (state.actor_opt, "step", _ranged(state.actor_opt.step, "adam")),
               (state.critic_opt, "step", _ranged(state.critic_opt.step, "adam"))]
    # an instance attribute that shadows a method is deleted afterwards; what
    # was the object's own (a module's function, a class's method) is put back
    saved = [(obj, name, name in vars(obj), vars(obj).get(name)) for obj, name, _ in patches]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            window()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        for obj, name, own, old in saved:
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
    events = prof.events()
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    # device-side events other than the ranges that record_function and the
    # optimizer's step annotation mirror onto the device timeline
    labels = {"kl_bisection", "forward", "minibatch_loss", "optimizer_step", "projection", "backward", "adam"}
    annotations = {e.name for e in events if e.device_type == cpu and getattr(e, "is_user_annotation", False)} | labels
    kernels = _device_kernels(events, annotations)
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    per_mb = len(kernels) / n
    idle = 100 - 100 * busy_us / 1e6 / wall
    print(f"[profile] {tag}profiled window: {1e3 * wall:.1f} ms wall for {n} minibatches, {per_mb:.0f} device "
          f"kernels per minibatch, device busy {busy_us / 1e3:.1f} ms = {100 * busy_us / 1e6 / wall:.1f}% "
          f"(idle {idle:.1f}%)")

    # each device kernel belongs to the CPU op that launched it; an op belongs
    # to the range whose host interval holds its start (the backward's ops run
    # on autograd's thread while the main thread waits inside its range)
    ops = [(e.time_range.start, len(e.kernels), sum(k.duration for k in e.kernels))
           for e in events if e.device_type == cpu and e.kernels]
    spans = {label: [(e.time_range.start, e.time_range.end) for e in events if e.name == label and e.device_type == cpu]
             for label in labels}

    def inside(label):
        count = dev = 0.0
        for start, k, d in ops:
            if any(a <= start < b for a, b in spans[label]):
                count, dev = count + k, dev + d
        return count, dev, sum(b - a for a, b in spans[label])

    raw = {label: inside(label) for label in labels}
    parts = {
        "forward": raw["forward"], "projection": raw["projection"],
        "loss": tuple(m - f - p for m, f, p in zip(raw["minibatch_loss"], raw["forward"], raw["projection"])),
        "backward": raw["backward"], "adam": raw["adam"],
        "clip": tuple(o - a for o, a in zip(raw["optimizer_step"], raw["adam"])),
    }
    total = (sum(k for _, k, _ in ops), sum(d for _, _, d in ops), 1e6 * wall)
    parts["other"] = tuple(t - sum(v[i] for v in parts.values()) for i, t in enumerate(total))
    for label in PARTS:
        k, d, h = parts[label]
        print(f"[profile] {tag}  {label:10s} {k / n:7.0f} device kernels, {d / 1e3 / n:7.3f} ms of device time, "
              f"{h / 1e3 / n:7.3f} ms of host time per minibatch")
    k, d, h = raw["kl_bisection"]
    print(f"[profile] {tag}kl_bisection: {k / n:.0f} device kernels per minibatch, {d / 1e3:.2f} ms of device time = "
          f"{100 * d / max(busy_us, 1):.1f}% of the busy time; {h / 1e3:.1f} ms of host time = "
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
