"""Bytes and f32 operations of one cloth position solve (the count behind
`cloth_solve_roofline.*`): the frozen copy of the port's `solve_cost`, kept
with the reference (`reference/frozen/sim/cloth_solve.py`). The benchmark
passes no contacts or self-collision hits, so the count is the least any
input needs and a roofline share from it is a lower bound."""

from ..reference.frozen.sim.cloth_solve import solve_cost  # noqa: F401
