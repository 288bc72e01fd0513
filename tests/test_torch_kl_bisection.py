"""The KL projection's bisection for eta (`rl/projections/kl.py`): the CPU
path, the CUDA path's operand checks, and the CUDA source run on the CPU.

`_solve_eta` runs the plain version on CPU tensors and launches nothing.
`csrc/kl_bisection.cu` is compiled by the host C++ compiler against a small
stand-in for the CUDA runtime (each block's threads one after another;
`__fadd_rn` and its kin plain IEEE operations, no contraction; `logf`,
`log1pf`, `expm1f` the C library's) and held against the plain version on
the CPU: every row that needs no projection gives 0 in both, NaN and inf
rows included, and every other row's eta agrees within RTOL. The C library
and PyTorch's CPU kernels round the logarithms apart, and the two sum the K
terms in another order, so the CPU cannot ask for the same bits; on the card,
where the kernel calls the same math library as PyTorch and sums in its
order, the bits are equal (tests/test_torch_cuda.py).
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_torch.cuda_build import CSRC_DIR
from geometry_rl_torch.rl.projections import kl
from geometry_rl_torch.utils.trace import counting

LAUNCH = re.compile(r"(kl_bisection_kernel<K>)<<<(.*?)>>>\(")
# the last axes the shared configurations give the projection: rigid pushing 3; rigid insertion,
# sliding and rope 6; cloth 12
SHARED_K = (3, 6, 12)
# eta where the f32 constraint crosses 0: each KL term 0.5 (r - 1 - log r) of a ratio r near 1 carries the
# rounding of r - 1, ~1e-4 of a term at the bounds used here, so a logarithm an ulp apart moves the crossing
# by up to ~1e-4 of eta (1.84e-4 the largest over every K and eps kind of the test below)
RTOL = 1e-3

CUDA_RUNTIME_STAND_IN = r"""
#pragma once
#include <cmath>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
namespace {  // internal linkage: no symbol meets another emulation's in one process
struct Index { unsigned x; };
inline thread_local Index threadIdx, blockIdx;
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }

template <class Kernel, class... Args>
void emulated_launch(Kernel kernel, unsigned grid, int block, int, cudaStream_t, Args... args) {
  for (unsigned b = 0; b < grid; ++b)
    for (int t = 0; t < block; ++t) {
      blockIdx.x = b, threadIdx.x = t;
      kernel(args...);
    }
}
}  // namespace
"""


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    build = tmp_path_factory.mktemp("kl_bisection_emulation")
    (build / "cuda_runtime.h").write_text(CUDA_RUNTIME_STAND_IN)
    source, launches = LAUNCH.subn(r"emulated_launch(\1, \2, ", open(f"{CSRC_DIR}/kl_bisection.cu").read())
    assert launches == 1, "the launch line changed; update LAUNCH"
    (build / "kl_bisection.cu").write_text(source)
    out = build / "libkl_bisection.so"
    cmd = [cxx, "-std=c++17", "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-Wno-unknown-pragmas", f"-I{build}",
           "-o", str(out), "-x", "c++", str(build / "kl_bisection.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(out)).kl_bisection_launch
    fn.argtypes, fn.restype = kl.KERNEL_ARGTYPES, ctypes.c_int
    return fn


def emulate(fn, var, old_var, eps, iters=kl._BISECT_ITERS):
    """The kernel on CPU tensors, launched as `_solve_eta_cuda` launches it: (error, eta)."""
    eps_stride = 0 if all(s == 0 for s in eps.stride()) else 1
    eps = eps if eps_stride == 0 else eps.contiguous()
    eta = torch.full(var.shape[:-1], float("nan"))
    err = fn(var.data_ptr(), old_var.data_ptr(), eps.data_ptr(), eps_stride, eta.data_ptr(), eta.numel(),
             var.shape[-1], iters, kl._ETA_MAX, None)
    return err, eta


def operands(K, rows, seed, eps_kind):
    """var, old_var [rows, K] a log-normal step apart (scales from 1e-4 to 1),
    and eps [rows] (log-uniform on [1e-5, 1e-1], or one such bound as a
    stride-0 view), so that about half the rows need a projection."""
    rng = np.random.default_rng(seed)
    old_var = np.exp(rng.normal(scale=1.5, size=(rows, K))).astype(np.float32)
    step = rng.normal(size=(rows, 1)) * 10.0 ** rng.uniform(-3, 0, size=(rows, 1))
    var = (old_var * np.exp(step * rng.normal(size=(rows, K)))).astype(np.float32)
    if eps_kind == "broadcast":
        eps = torch.broadcast_to(torch.tensor(np.float32(2.5e-3)), (rows,))
    else:
        eps = torch.as_tensor((10.0 ** rng.uniform(-5, -1, size=rows)).astype(np.float32))
    return torch.as_tensor(var), torch.as_tensor(old_var), eps


def relative_gap(got, want):
    """max |got - want| / |want| over the rows where want is not 0."""
    active = want != 0
    return ((got - want).abs()[active] / want.abs()[active]).max().item() if active.any() else 0.0


@pytest.mark.parametrize("eps_kind", ["broadcast", "per_row"])
@pytest.mark.parametrize("K", SHARED_K)
def test_cpu_tensors_take_the_plain_loop(K, eps_kind):
    """On CPU tensors `_solve_eta` gives the plain version's bits and launches
    nothing."""
    var, old_var, eps = operands(K, 256, K, eps_kind)
    with counting("kernels.kl_bisection") as launched:
        eta = kl._solve_eta(var, old_var, eps)
    assert launched == {"kernels.kl_bisection": 0}
    assert torch.equal(eta, kl._solve_eta_plain(var, old_var, eps))
    assert 0 < (eta > 0).sum() < eta.numel()  # both kinds of row


def test_cuda_path_refuses_what_the_kernel_does_not_take():
    """No fallback: f64 or bf16, a last axis beyond the registers' limit, a
    shape mismatch, or tensors off the card raise before anything is built."""
    var, old_var, eps = operands(6, 8, 0, "per_row")
    wide = torch.ones(8, kl.KERNEL_MAX_K + 1)
    for args, err in (((var.double(), old_var.double(), eps.double()), TypeError),
                      ((var.bfloat16(), old_var.bfloat16(), eps.bfloat16()), TypeError),
                      ((wide, wide, eps), ValueError),
                      ((var, old_var[:4], eps), ValueError),
                      ((var, old_var, eps), ValueError)):  # on the CPU
        with counting("kernels.kl_bisection") as launched, pytest.raises(err):
            kl._solve_eta_cuda(*args)
        assert launched == {"kernels.kl_bisection": 0}


def test_kernel_limit_is_the_sources():
    source = open(f"{CSRC_DIR}/kl_bisection.cu").read()
    assert f"constexpr int kMaxK = {kl.KERNEL_MAX_K};" in source


@pytest.mark.parametrize("eps_kind", ["broadcast", "per_row"])
@pytest.mark.parametrize("K", list(range(1, kl.KERNEL_MAX_K + 1)))
def test_emulated_kernel_matches_plain_loop(kernel, K, eps_kind):
    """Every K the kernel takes, 300 rows (not a multiple of the block): the
    same rows need a projection, and their eta agree within RTOL."""
    var, old_var, eps = operands(K, 300, 100 + K, eps_kind)
    err, got = emulate(kernel, var, old_var, eps)
    want = kl._solve_eta_plain(var, old_var, eps)
    assert err == 0
    assert torch.equal(got > 0, want > 0)
    assert relative_gap(got, want) <= RTOL


def test_emulated_kernel_on_special_rows(kernel):
    """Rows inside the ball, var equal to old_var, eps 0 and negative (every
    round violated: eta runs to ETA_MAX), and NaN, inf and 0 in var, old_var
    or eps: the plain version's eta or its 0, and NaN nowhere."""
    K = 6
    var, old_var, eps = operands(K, 16, 3, "per_row")
    var[0] = old_var[0]  # equal: KL 0, inside any ball
    var[1], eps[1] = old_var[1], 0.0  # equal, bound 0: 0 > 0 is false
    eps[2] = -1.0  # violated at every eta
    var[3, 2] = float("nan")
    old_var[4, 0] = float("nan")
    eps[5] = float("nan")
    var[6, 1] = float("inf")
    old_var[7, 3] = float("inf")
    eps[8] = float("inf")
    var[9, 4] = 0.0
    old_var[10, 5] = 0.0
    var[11] = old_var[11] * 1.0001  # just inside the default bound
    err, got = emulate(kernel, var, old_var, eps)
    want = kl._solve_eta_plain(var, old_var, eps)
    assert err == 0 and not torch.isnan(got).any()
    assert torch.equal(got == 0, want == 0), (got, want)
    assert relative_gap(got, want) <= RTOL
    assert got[0] == 0 and got[1] == 0 and got[3] == 0 and got[5] == 0 and got[8] == 0 and got[11] == 0
    assert got[2] > 0.99 * kl._ETA_MAX


def test_c_entry_refuses_what_it_cannot_run(kernel):
    """K of 0 or beyond the limit, a negative row count or round count, an
    eps stride other than 0 or 1: cudaErrorInvalidValue, nothing written; no
    rows: nothing to do."""
    var, old_var, eps = operands(4, 8, 0, "per_row")
    eta = torch.full((8,), float("nan"))
    for K, rows, iters, stride in ((0, 8, 60, 1), (kl.KERNEL_MAX_K + 1, 8, 60, 1), (4, -1, 60, 1), (4, 8, -1, 1),
                                   (4, 8, 60, 2)):
        assert kernel(var.data_ptr(), old_var.data_ptr(), eps.data_ptr(), stride, eta.data_ptr(), rows, K, iters,
                      kl._ETA_MAX, None) == 1
    assert kernel(var.data_ptr(), old_var.data_ptr(), eps.data_ptr(), 1, eta.data_ptr(), 0, 4, 60, kl._ETA_MAX,
                  None) == 0
    assert torch.isnan(eta).all()
