"""One run of a cell: build the port's trainer from the cell's configuration,
set up (warm-up and capture), measure the window, trace a slice when asked,
then free the port and judge its captured outputs against the reference.

`run_cell` is the whole run apart from the look for a card, so that the
tests can drive it on the CPU at a small size with the system under test
replaced (`system`: the port, or the reference's control in its place) or
broken (`faults.py`).

A traced run also records the port's spans (`spans.py`) from before the
system is built to the window's close, and its slice is profiled a second
time with the spans on (`trace.py`); a run with `trace` off records none.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import sys
import time
from typing import Callable, Dict, Optional

import torch

from . import check, manifest, spans
from .counts import flops as flop_counts
from . import loops
from .loops import Window
from .peaks import PEAKS


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader reads."""

    cell: manifest.Cell
    config: Dict
    loop: str  # "train" or "rollout"
    window: Window
    control_steps: int  # per train iteration
    minibatch_steps: int  # per train iteration
    slice: Optional[object]  # trace.Slice
    flops: Optional[Dict[str, float]]  # counts.flops.count
    peak: Optional[Dict[str, float]]  # peaks.PEAKS of the device
    end_to_end: Dict[str, float]
    spans: Optional[spans.Recorded] = None  # the port's spans, in a traced run


def log(message: str) -> None:
    print(f"[benchmark] {message}", file=sys.stderr, flush=True)


def host_clocks() -> Dict[str, float]:
    """The process's and this thread's CPU seconds: read at the window's ends
    beside its wall time, they say whether a slow window was a slow host."""
    return {"process_cpu_s": time.process_time(), "thread_cpu_s": time.thread_time()}


def build_system(cfg: Dict, device, system: str):
    if system == "port":
        from geometry_rl_torch.config import trainer_from_config

        return trainer_from_config(cfg, device=device)
    if system == "control":
        from . import reference

        return reference.build(cfg, device, precision="control")
    raise ValueError(f"system must be 'port' or 'control', got {system!r}")


def run_cell(cell: manifest.Cell, seed: int, seconds: Optional[float], trace: bool, device, t_start: float,
             system: str = "port", fault: Optional[Callable] = None) -> Dict:
    """One run; returns the result's fields (`correct`, `attempted`,
    `failed`, `metrics`, `device`, `breakdown` when traced, `check`).
    `seconds=None` skips the window (a train cell's check reads set-up's
    first iteration and the one after it; a rollout cell runs until its
    sampled steps have run);
    `fault(trainer, loop)` breaks the system under test after it is built."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = copy.deepcopy(cell.config)
    with contextlib.ExitStack() as recorder:
        rec = None
        if trace:
            from geometry_rl_torch.utils.trace import recording

            rec = recorder.enter_context(recording())
        trainer = build_system(cfg, device, system)
        if fault is not None:
            fault(trainer, cell.loop)
        state = trainer.init(torch.Generator(device=device).manual_seed(seed))
        loop = loops.load(cell)(trainer, state, cell, seed)
        control_steps, minibatch_steps = loop.control_steps, loop.minibatch_steps
        loop.setup()
        if cuda:
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s")

        # set-up's objects are kept out of the collector's sweeps, and none runs inside the window
        gc.collect()
        gc.freeze()
        gc.disable()
        try:
            clocks = host_clocks()
            window_ns = time.perf_counter_ns()
            window = loop.window(seconds)
            window_ns = (window_ns, time.perf_counter_ns())
            clocks = {k: v - clocks[k] for k, v in host_clocks().items()}
        finally:
            gc.enable()
    recorded = spans.Recorded(rec, window_ns) if rec is not None else None
    end_to_end = loop.end_to_end(window) if seconds is not None else {}
    end_to_end["setup_s"] = setup_s
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    log(f"window {window.seconds:.3f} s, {window.attempted} attempted, {memory_peak} bytes at the peak")
    log(f"window's host CPU, s: {clocks} over {(window_ns[1] - window_ns[0]) / 1e9:.3f} wall")
    if window.collect_s:
        log(f"window's iterations, collect s: {[round(c, 3) for c in window.collect_s]}, "
            f"update s: {[round(u, 3) for u in window.update_s]}")
    t0 = time.perf_counter()
    loop.finish()
    log(f"finish {time.perf_counter() - t0:.3f} s")
    slice_ = None
    if trace:
        from .trace import traced_slice

        t0 = time.perf_counter()
        slice_ = traced_slice(loop, spans=True)
        log(f"traced slice {slice_.wall_s:.3f} s, {slice_.kernels} device ops; both passes reduced in "
            f"{time.perf_counter() - t0:.3f} s; kernels by span: {slice_.in_span}")
    capture = loop.capture
    del loop, state, trainer
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    numbers = check.judge(cell, cfg, seed, capture, device, log)
    log(f"check {time.perf_counter() - t0:.3f} s")
    correct = check.is_correct(numbers)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": correct, "attempted": window.attempted, "failed": window.failed}
    if trace:
        t0 = time.perf_counter()
        counted = flop_counts.count(cfg, device)
        log(f"FLOP count {time.perf_counter() - t0:.3f} s: {counted}")
        ctx = Context(cell=cell, config=cfg, loop=cell.loop, window=window, control_steps=control_steps,
                      minibatch_steps=minibatch_steps, slice=slice_, flops=counted, peak=PEAKS.get(kind),
                      end_to_end=end_to_end, spans=recorded)
        result["metrics"] = manifest.read_per_layer(cell, ctx)
        dev.update(busy_s=slice_.busy_s, window_s=slice_.wall_s)
        result["device"] = dev
        result["breakdown"] = {"device_ops": slice_.device_ops, "idle_gaps": slice_.idle_gaps}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in end_to_end.items() if k in units}
        result["device"] = dev
    result["check"] = numbers
    return result
