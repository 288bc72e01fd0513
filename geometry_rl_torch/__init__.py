"""geometry_rl_torch — the PyTorch / CUDA port of `geometry_rl_tpu`.

The JAX package stays the reference; this package mirrors its layout module
for module (sim/, envs/, graphs/, models/, rl/, train/, utils/, parallel/) and is held
against it by the `tests/test_torch_*.py` parity tests.

It imports torch and numpy, never jax. The YAML task configs are read as data
from `geometry_rl_tpu/configs/` by the port's own loader (`.config`).

Every TPU kernel of the ported path is a hand-written CUDA kernel under
`csrc/`, built at first use into `_build/` (see `cuda_build.py`). Each kernel
module keeps a plain PyTorch version beside it: CPU tensors go to the plain
version, CUDA tensors to the kernel, and nothing falls back.
"""

__version__ = "0.1.0"
