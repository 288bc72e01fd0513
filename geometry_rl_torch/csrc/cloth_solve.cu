// K2's port: the fused XPBD cloth position solve in K2's operation order.
//
// Replaces `geometry_rl_tpu/sim/pallas_cloth.py:cloth_position_solve_tiled`
// (kernel K2, `_kernel_tiled` -> `_solve_tile`), which the cloth env runs
// twice per control step in solver mode "auto" / "tiled". The solve, what
// bounds it on this card and the design are in `cloth_solve_common.cuh`;
// this file instantiates it with K2's order (multiply by the inverse
// distance) and exports the C entry point `cloth_solve_launch`.

#include "cloth_solve_common.cuh"

extern "C" __global__ void __launch_bounds__(cloth::kThreads) cloth_solve_kernel(const cloth::SolveArgs a) {
  cloth::solve<cloth::Order::kInverse, false>(a);
}

extern "C" __global__ void __launch_bounds__(cloth::kThreads) cloth_solve_self_kernel(const cloth::SolveArgs a) {
  cloth::solve<cloth::Order::kInverse, true>(a);
}

CLOTH_SOLVE_C_ENTRY(cloth_solve_launch, cloth_solve_kernel, cloth_solve_self_kernel)
