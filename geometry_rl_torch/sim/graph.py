"""A physics step replayed from one CUDA graph.

The rigid env's XPBD step (`step_physics`) is a fixed chain of some 17,000
small tensor operations on static shapes: it reads nothing back to the host
and draws no random numbers, so launching it op by op costs far more host
time than the card spends on it. `PhysicsGraph` captures the chain once and
replays it:

    graph = PhysicsGraph(fn)      # fn: RigidBodyState -> RigidBodyState
    bodies = graph(bodies)        # the first call captures, every later one replays

The first call runs `fn` eagerly once on a side stream (as
`torch.cuda.graphs` asks before a capture) and returns that result; it then
captures `fn` under `torch.no_grad()` into a graph with its own memory pool,
whose static inputs are the four [B, NB, 3|4] tensors of a `RigidBodyState`.
Every later call copies its input into them, replays, and returns clones of
the static outputs, so a returned state stays the caller's own across later
replays. `fn` is called with the static inputs: whatever it reads of them
(the plate's pose in its SDF, say) is read afresh on every replay. The graph
replays the same kernels in the same order on the same shapes, so its
results are the eager chain's bits.

Host code inside `fn` (its spans, `sim.*`) runs in the warm-up and the
capture pass only. Counters: `sim.physics_graph.captures` once a graph,
`sim.physics_graph.replays` once a replay.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.trace import count
from .types import RigidBodyState


class PhysicsGraph:
    """`fn` captured on the first call, replayed on every later one."""

    def __init__(self, fn: Callable[[RigidBodyState], RigidBodyState]):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static_in: Optional[RigidBodyState] = None
        self.static_out: Optional[RigidBodyState] = None

    def __call__(self, bodies: RigidBodyState) -> RigidBodyState:
        if self.graph is None:
            return self._capture(bodies)
        for static, x in zip(self.static_in, bodies):
            static.copy_(x)
        self.graph.replay()
        count("sim.physics_graph.replays")
        return RigidBodyState(*(t.clone() for t in self.static_out))

    def _capture(self, bodies: RigidBodyState) -> RigidBodyState:
        device = bodies.pos.device
        with torch.cuda.device(device), torch.no_grad():
            self.static_in = RigidBodyState(*(t.clone() for t in bodies))
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                eager = self.fn(self.static_in)
            torch.cuda.current_stream().wait_stream(side)
            # cloned on this stream before the capture, which synchronises the
            # device: no read of the side stream's blocks is pending when they are freed
            out = RigidBodyState(*(t.clone() for t in eager))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.static_out = self.fn(self.static_in)
            self.graph = graph
            count("sim.physics_graph.captures")
            return out
