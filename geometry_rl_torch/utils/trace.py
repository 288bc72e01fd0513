"""Spans and counters inside the port's layers.

    with span("envs.physics"):
        ...
    count("kernels.cloth_solve")

    @spanned("train.policy")
    def _policy_dist(...): ...

`span(name)` marks a stretch of host time. Recording is off by default: a
span is then one shared object that does nothing, returned after one check
of a module global. Inside `recording()` each span appends
`Span(name, parent, start_ns, end_ns)` to the recording on the host clock
(`time.perf_counter_ns`); while `torch.profiler` is active it also opens
`torch.profiler.record_function(name)`, so that a profiled run shows each
span on the profiler's clock and its mirror on the device timeline.

`count(name, n)` adds to an always-on integer counter (`COUNTERS`): a dict
add on the host under a lock, with no device sync. `counting(*names)` reads
how far some counters moved over a block, recording or not.

Span names start with the layer they mark (`setup.`, `train.`, `rl.`,
`envs.`, `sim.`, `kernels.`, `graphs.`, `models.`). Spans nest per thread:
a span opened on the autograd engine's thread during a backward is a root
there, although the caller waits inside its own span. Spans from several
threads go into one recording; each takes its slot under a lock.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import torch

# name -> count since the process started; never reset by the port
COUNTERS: Dict[str, int] = {}
# guards COUNTERS, and a recording's slots while it is on
_LOCK = threading.Lock()


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span on the same thread in `Recording.spans`, -1 for none
    start_ns: int
    end_ns: int


class Recording:
    """The spans recorded so far, each where it opened in `spans` (None
    until it closes)."""

    def __init__(self):
        self.spans: List[Optional[Span]] = []
        self._local = threading.local()

    def _stack(self) -> List[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def totals(self, start_ns: int = 0, end_ns: Optional[int] = None) -> Dict[str, Tuple[int, float, float]]:
        """Per span name, over the spans that start in [start_ns, end_ns):
        (calls, host seconds, self seconds). A span's self time is its
        duration less its children's."""
        children_ns: Dict[int, int] = {}
        for s in self.spans:
            if s is not None and s.parent >= 0:
                children_ns[s.parent] = children_ns.get(s.parent, 0) + s.end_ns - s.start_ns
        out: Dict[str, Tuple[int, float, float]] = {}
        for i, s in enumerate(self.spans):
            if s is None or s.start_ns < start_ns or (end_ns is not None and s.start_ns >= end_ns):
                continue
            calls, host, own = out.get(s.name, (0, 0.0, 0.0))
            ns = s.end_ns - s.start_ns
            out[s.name] = (calls + 1, host + ns / 1e9, own + (ns - children_ns.get(i, 0)) / 1e9)
        return out


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_recording: Optional[Recording] = None


class _On:
    __slots__ = ("rec", "name", "index", "parent", "ranged", "start_ns")

    def __init__(self, rec: Recording, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        rec = self.rec
        stack = rec._stack()
        self.parent = stack[-1] if stack else -1
        with _LOCK:
            self.index = len(rec.spans)
            rec.spans.append(None)
        stack.append(self.index)
        self.ranged = None
        if torch.autograd._profiler_enabled():
            self.ranged = torch.profiler.record_function(self.name)
            self.ranged.__enter__()
        self.start_ns = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self.ranged is not None:
            self.ranged.__exit__(*exc)
        self.rec._stack().pop()
        self.rec.spans[self.index] = Span(self.name, self.parent, self.start_ns, end_ns)
        return False


def span(name: str):
    """A context manager over a stretch of host time named `name`."""
    rec = _recording
    if rec is None:
        return _OFF
    return _On(rec, name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    """A decorator: each call of the function is a span `name`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        COUNTERS[name] = COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def counting(*names: str) -> Iterator[Dict[str, int]]:
    """Yields a dict that holds, once the block has ended, how far each
    counter of `names` moved inside it."""
    before = {name: COUNTERS.get(name, 0) for name in names}
    moved: Dict[str, int] = {}
    try:
        yield moved
    finally:
        moved.update({name: COUNTERS.get(name, 0) - n for name, n in before.items()})


@contextlib.contextmanager
def recording() -> Iterator[Recording]:
    """Records every span opened inside the block, on any thread; one
    recording at a time."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already on")
    rec = Recording()
    _recording = rec
    try:
        yield rec
    finally:
        _recording = None
