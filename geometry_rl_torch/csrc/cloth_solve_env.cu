// K1's port: the fused XPBD cloth position solve in K1's operation order.
//
// Replaces `geometry_rl_tpu/sim/pallas_cloth.py:cloth_position_solve`
// (kernel K1, `_kernel` -> `_solve_env`), the one-env-per-program solve that
// the cloth env runs with `use_pallas_solver=True`, twice per control step.
// The solve, what bounds it on this card and the design are in
// `cloth_solve_common.cuh`; this file instantiates it with K1's order
// (normalise first: n = d / max(|d|, 1e-9), lam = -c / denom * mask,
// dx = lam * n) and exports the C entry point `cloth_solve_env_launch`.

#include "cloth_solve_common.cuh"

extern "C" __global__ void __launch_bounds__(cloth::kThreads) cloth_solve_env_kernel(const cloth::SolveArgs a) {
  cloth::solve<cloth::Order::kNormalizeFirst, false>(a);
}

extern "C" __global__ void __launch_bounds__(cloth::kThreads) cloth_solve_env_self_kernel(const cloth::SolveArgs a) {
  cloth::solve<cloth::Order::kNormalizeFirst, true>(a);
}

CLOTH_SOLVE_C_ENTRY(cloth_solve_env_launch, cloth_solve_env_kernel, cloth_solve_env_self_kernel)
