"""The traced slice: profiler ranges put on the port's calls from here (the
port is not edited), `torch.profiler` over the loop's slice, and the trace
reduced to what the per-layer metrics read.

Ranges (`RANGES`): `env.step`, `policy` (graph build and policy forward),
`critic`, `minibatch_step`, `projection`, `kl_bisection`, and around each
call of the two kernels' entries, `segment_sum` (`models/common.py`'s
`segment_sum`) and `cloth_solve` (`envs/cloth.py`'s
`cloth_position_solve`), whose calls' shapes are recorded for their bounds.
A kernel belongs to a range when its device interval lies inside the range's
mirror on the device timeline (every kernel launched inside the range,
whatever its name or launcher); an idle gap of the device is named by the
innermost range the host was in at the gap's middle.

With `spans=True` (a traced run; `harness.py`), a second profiled pass of
the slice runs under the port's span recording as well. The spans open
`record_function` ranges inside the outside ones, and a range's mirror
holds only the kernels launched with it innermost, so the first pass keeps
every number above and the second gives only what needs the spans: the
kernels of each span (`Slice.in_span`: its own mirror and its descendants'
mirrors, that is every kernel, memcpy and memset launched on its thread
while it was open, each found by the correlation id it shares with the
runtime call that launched it; a CUDA graph's kernels share their replay's),
and the idle gaps named by the innermost of the ranges and the spans.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .capture import Patches
from .counts.cloth_solve import solve_cost
from .counts.segment_sum import segment_sum_bytes

RANGES = ("env.step", "policy", "critic", "minibatch_step", "projection", "kl_bisection", "segment_sum", "cloth_solve")
TOP = 10  # entries of each list of the breakdown
NAME_CHARS = 160  # a device op's name is cut to this many characters in the breakdown
CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


@dataclasses.dataclass
class Calls:
    """The calls of one kernel entry in the slice: their bounds' inputs."""

    bytes: List[int] = dataclasses.field(default_factory=list)
    flops: List[int] = dataclasses.field(default_factory=list)


class _Ranged:
    """An object's call under a profiler range; attributes pass through."""

    def __init__(self, obj, label: str):
        self._obj, self._label = obj, label

    def __call__(self, *args, **kwargs):
        with torch.profiler.record_function(self._label):
            return self._obj(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._obj, name)


def _ranged(fn: Callable, label: str, record: Optional[Callable] = None) -> Callable:
    def ranged(*args, **kwargs):
        if record is not None:
            record(*args, **kwargs)
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)

    return ranged


def range_patches(trainer, calls: Dict[str, Calls]) -> Patches:
    """The ranges on `trainer` and on the two kernel entries' call sites."""
    from geometry_rl_torch.envs import cloth as port_cloth
    from geometry_rl_torch.models import common as port_common
    from geometry_rl_torch.rl.projections import kl as port_kl

    def seg(values, csr):
        calls["segment_sum"].bytes.append(segment_sum_bytes(
            tuple(values.shape), values.element_size(), csr.perm.numel(), csr.offsets.numel(), csr.num_segments))

    def cloth(spec, x, *args, **kwargs):
        nbytes, flops = solve_cost(spec, x.shape[0])
        calls["cloth_solve"].bytes.append(nbytes)
        calls["cloth_solve"].flops.append(flops)

    return Patches([
        (trainer.env, "step", _ranged(trainer.env.step, "env.step")),
        (trainer, "_policy_dist", _ranged(trainer._policy_dist, "policy")),
        (trainer, "_value", _ranged(trainer._value, "critic")),
        (trainer, "_minibatch_step", _ranged(trainer._minibatch_step, "minibatch_step")),
        (trainer, "projection", _Ranged(trainer.projection, "projection")),
        (port_kl, "_solve_eta", _ranged(port_kl._solve_eta, "kl_bisection")),
        (port_common, "segment_sum", _ranged(port_common.segment_sum, "segment_sum", seg)),
        (port_cloth, "cloth_position_solve", _ranged(port_cloth.cloth_position_solve, "cloth_solve", cloth)),
    ])


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _inside(intervals: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and intervals[i][0] <= t <= intervals[i][1]


def _innermost(host_ranges: Dict[str, List[Tuple[float, float]]]) -> Callable[[float], str]:
    """t -> the label of the shortest host range holding t. The ranges'
    ends cut time into pieces; longer ranges are painted first, so each piece
    keeps the innermost label."""
    spans = sorted(((b - a, a, b, label) for label, ivs in host_ranges.items() for a, b in ivs), reverse=True)
    cuts = sorted({t for _, a, b, _ in spans for t in (a, b)})
    labels = ["outside the ranges"] * len(cuts)
    for _, a, b, label in spans:
        for i in range(bisect.bisect_left(cuts, a), bisect.bisect_left(cuts, b)):
            labels[i] = label

    def label_at(t: float) -> str:
        i = bisect.bisect_right(cuts, t) - 1
        return labels[i] if 0 <= i < len(cuts) else "outside the ranges"

    return label_at


@dataclasses.dataclass
class Slice:
    """The profiled slice, reduced."""

    wall_s: float
    control_steps: int
    minibatch_steps: int
    busy_s: float  # device time of every kernel, memcpy and memset
    kernels: int
    in_range: Dict[str, Tuple[int, float]]  # label -> (device kernels, device seconds) inside it
    calls: Dict[str, Calls]
    device_ops: List[List]  # [name, seconds], the most device time first
    idle_gaps: List[List]  # [host range, seconds] of the device's idle time; with spans, the second pass's
    in_span: Dict[str, Tuple[int, float]] = dataclasses.field(default_factory=dict)  # span -> (kernels, device s)


def _is_kernel(e) -> bool:
    """A device op: a CUDA event that is no range's mirror and no optimizer annotation."""
    return (e.device_type == CUDA and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("Optimizer."))


def _idle_gaps(kernels: List[Tuple[float, float, str]], host_ranges: Dict[str, List[Tuple[float, float]]]) -> List[List]:
    """The device's idle gaps between the sorted `kernels`, summed by the
    innermost host range at each gap's middle, the longest first."""
    innermost = _innermost(host_ranges)
    gaps: Dict[str, float] = defaultdict(float)
    end = kernels[0][1] if kernels else 0.0
    for a, b, _ in kernels[1:]:
        if a > end:
            gaps[innermost(0.5 * (a + end))] += (a - end) / 1e6
        end = max(end, b)
    return [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]


def reduce_events(events, wall_s: float, sizes: Dict[str, int], calls: Dict[str, Calls]) -> Slice:
    kernels: List[Tuple[float, float, str]] = []
    device_ranges, host_ranges = defaultdict(list), defaultdict(list)
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == CUDA and e.name in RANGES:
            device_ranges[e.name].append((start, end))
        elif _is_kernel(e):
            kernels.append((start, end, e.name))
        elif e.device_type == CPU and e.name in RANGES:
            host_ranges[e.name].append((start, end))
    kernels.sort()
    in_range = {}
    for label in RANGES:
        merged = _merge(device_ranges[label])
        inner = [(a, b) for a, b, _ in kernels if _inside(merged, 0.5 * (a + b))]
        in_range[label] = (len(inner), sum(b - a for a, b in inner) / 1e6)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in kernels:
        by_name[name[:NAME_CHARS]] += (b - a) / 1e6
    busy = sum(b - a for a, b in _merge([(a, b) for a, b, _ in kernels])) / 1e6
    return Slice(
        wall_s=wall_s, control_steps=sizes["control_steps"], minibatch_steps=sizes["minibatch_steps"], busy_s=busy,
        kernels=len(kernels), in_range=in_range, calls=calls,
        device_ops=[[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_gaps(kernels, host_ranges),
    )


RUNTIME = "cu"  # a CUDA runtime or driver call's name starts so (cudaLaunchKernel, cudaGraphLaunch, cuLaunchKernel)


def reduce_spans(events, span_names) -> Tuple[Dict[str, Tuple[int, float]], List[List]]:
    """From the second pass's events: each span's (kernels, device seconds),
    the device ops whose runtime call ran on the span's thread while it was
    open; and the idle gaps named by the innermost of the ranges and the spans."""
    names = set(span_names)
    launched_at: Dict[int, Tuple[int, float]] = {}  # correlation id -> (thread, start) of the runtime call
    opened = defaultdict(list)  # (span, thread) -> host intervals
    host_ranges = defaultdict(list)
    kernels = []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == CUDA and (e.name in names or e.name in RANGES):
            continue  # a span's or a range's mirror
        if _is_kernel(e):
            kernels.append((start, end, e.name, e.id))
        elif e.device_type == CPU:
            if e.name.startswith(RUNTIME):
                launched_at[e.id] = (e.thread, start)
            if e.name in names:
                opened[e.name, e.thread].append((start, end))
            if e.name in names or e.name in RANGES:
                host_ranges[e.name].append((start, end))
    merged = {key: _merge(ivs) for key, ivs in opened.items()}
    in_span = {name: (0, 0.0) for name in names}
    for a, b, _, corr in kernels:
        call = launched_at.get(corr)
        if call is None:
            continue
        for (name, thread), ivs in merged.items():
            if thread == call[0] and _inside(ivs, call[1]):
                n, s = in_span[name]
                in_span[name] = (n + 1, s + (b - a) / 1e6)
    kernels.sort()
    return in_span, _idle_gaps([k[:3] for k in kernels], host_ranges)


def traced_slice(loop, spans: bool = False) -> Slice:
    """The loop's slice once unprofiled (a warm-up of its shapes), then
    under the ranges and `torch.profiler`, reduced; with `spans`, once more
    under the ranges, the port's span recording and the profiler, for the
    spans' kernels and the idle gaps by span."""
    loop.slice()
    calls = {"segment_sum": Calls(), "cloth_solve": Calls()}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with range_patches(loop.trainer, calls), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sizes = loop.slice()
        wall = time.perf_counter() - t0
    sliced = reduce_events(prof.events(), wall, sizes, calls)
    if spans:
        from geometry_rl_torch.utils.trace import recording

        shapes = {"segment_sum": Calls(), "cloth_solve": Calls()}  # the first pass's are the ones read
        with recording() as rec, range_patches(loop.trainer, shapes), torch.profiler.profile(activities=acts) as prof:
            loop.slice()
        names = {s.name for s in rec.spans if s is not None}
        sliced.in_span, sliced.idle_gaps = reduce_spans(prof.events(), names)
    return sliced
