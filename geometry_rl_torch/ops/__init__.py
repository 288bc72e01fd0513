"""The hot-op namespace (port of `geometry_rl_tpu/ops/__init__.py`).

Implementations live next to their consumers; this package re-exports the
performance-critical primitives:

- `gather_nodes` / `scatter_sum` / `scatter_mean`: graph message-passing
  gathers and scatters (`models/common.py`, index ops).
- `kl_diag_cov_projection`: the differentiable trust-region covariance
  projection (bisection dual solve, `rl/projections/kl.py`).
- `cloth_position_solve`: the fused XPBD cloth position solve, a whole solve
  (all iterations, constraint groups and contacts) per env: one entry for
  both TPU kernels, `kernel="tiled"` (the CUDA port of
  `cloth_position_solve_tiled`) or `"per_env"` (of `cloth_position_solve`),
  with its plain PyTorch version for CPU tensors (`sim/cloth_solve.py`).
- `polygon_sdf_2d` / `hole_plate_sdf`: analytic contact SDFs (`sim/shapes.py`).
"""

from ..models.common import gather_nodes, scatter_mean, scatter_sum  # noqa: F401
from ..rl.projections.kl import kl_diag_cov_projection  # noqa: F401
from ..sim.cloth_solve import ClothSolveSpec, cloth_position_solve  # noqa: F401
from ..sim.shapes import hole_plate_sdf, polygon_sdf_2d  # noqa: F401
