"""The CUDA source of the cloth kernels, run on the CPU.

`csrc/cloth_solve.cu` and `csrc/cloth_solve_env.cu` (with the shared
`csrc/cloth_solve_common.cuh`) are compiled by the host C++ compiler against
a small stand-in for the CUDA runtime: each block runs as its 128 threads
(std::thread) with a std::barrier for __syncthreads(), one block after
another. Held against the plain version on the real cloth_hanging topology,
this checks the kernels' indexing, thread ownership and pass structure where
there is no card. Timing and what the GPU compiler makes of the source are
the card's to show (tests/test_torch_cuda.py, chip_smoke.py).
"""

import ctypes
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch
import test_torch_common  # noqa: F401  (pins torch to one thread per test worker)

from geometry_rl_torch.cuda_build import CSRC_DIR
from geometry_rl_torch.envs import make_env
from geometry_rl_torch.sim.cloth_solve import KERNEL_ARGTYPES, cloth_position_solve_ref
from test_torch_cuda import folded_operands

ATOL = 2e-4  # the kernels' gate against the plain version (f32, another summation order)
LIBRARIES = ("cloth_solve", "cloth_solve_env")
LAUNCH = "kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);"

CUDA_STAND_IN = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <thread>
#include <vector>
struct float3 { float x, y, z; };
struct float4 { float x, y, z, w; };
inline float3 make_float3(float a, float b, float c) { return {a, b, c}; }
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct Index { int x; };
inline thread_local Index threadIdx, blockIdx;
#define __device__
#define __global__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
inline std::barrier<>* block_barrier;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
template <class Kernel, class Args>
void emulated_launch(Kernel kernel, int grid, int block, const Args& args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> barrier(block);
    block_barrier = &barrier;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = b; kernel(args); });
    for (auto& thread : threads) thread.join();
  }
}
"""


@pytest.fixture(scope="module")
def libraries(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    build = tmp_path_factory.mktemp("cloth_kernel_emulation")
    (build / "cuda_runtime.h").write_text(CUDA_STAND_IN)
    for name in os.listdir(CSRC_DIR):
        text = open(os.path.join(CSRC_DIR, name)).read()
        if name.endswith(".cuh"):
            assert text.count(LAUNCH) == 1, "the launch line moved; update LAUNCH"
            text = text.replace(LAUNCH, "emulated_launch(kernel, B, kThreads, a);")
        (build / name).write_text(text)

    def compile_one(name):
        out = build / f"lib{name}.so"
        cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas",
               f"-I{build}", "-o", str(out), "-x", "c++", str(build / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0 and "barrier" in proc.stderr:
            pytest.skip(f"the host compiler lacks C++20 <barrier>: {proc.stderr[:200]}")
        assert proc.returncode == 0, proc.stderr
        fn = getattr(ctypes.CDLL(str(out)), f"{name}_launch")
        fn.argtypes, fn.restype = KERNEL_ARGTYPES, ctypes.c_int
        return fn

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(compile_one, LIBRARIES)))


def emulate(fn, spec, x, prev, inv_mass, hanger, att_body_w, att_particle, groups, pair_mask, active,
            n_groups=None):
    out = torch.full_like(x, float("nan"))
    err = fn(
        x.data_ptr(), prev.data_ptr(), inv_mass.data_ptr(), hanger.data_ptr(), att_body_w.data_ptr(),
        att_particle.data_ptr(), groups.i.data_ptr(), groups.j.data_ptr(), groups.rest.data_ptr(),
        groups.mask.data_ptr(), groups.offset.data_ptr(), groups.compliance.data_ptr(),
        None if pair_mask is None else pair_mask.data_ptr(), None if active is None else active.data_ptr(),
        out.data_ptr(), x.shape[0], spec.num_particles, spec.num_bodies,
        len(spec.group_sizes) if n_groups is None else n_groups, int(sum(spec.group_sizes)), spec.iterations,
        spec.dt, spec.hook_radius, spec.hook_half_len, spec.hook_friction, spec.self_min_dist, None,
    )
    return err, out


@pytest.fixture(scope="module", params=[False, True], ids=["no_self_collision", "self_collision"])
def operands(request):
    env = make_env("cloth_hanging", num_envs=2, warmup_steps=0, self_collision=request.param, device="cpu")
    args = folded_operands(env, seed=3)
    return args, cloth_position_solve_ref(*args)


@pytest.mark.parametrize("name", LIBRARIES)
def test_emulated_kernel_matches_plain_version(libraries, operands, name):
    args, ref = operands
    err, out = emulate(libraries[name], *args)
    assert err == 0
    assert (ref - args[1]).abs().max().item() > 1e-2  # the solve really moves the state
    assert (out - ref).abs().max().item() <= ATOL


def test_emulated_orders_agree_and_differ(libraries, operands):
    """K1's and K2's operation orders give the same solve, not the same bits
    everywhere: the template parameter reaches the arithmetic."""
    args, _ = operands
    (_, k2), (_, k1) = emulate(libraries["cloth_solve"], *args), emulate(libraries["cloth_solve_env"], *args)
    assert (k1 - k2).abs().max().item() <= ATOL
    assert not torch.equal(k1, k2)


@pytest.mark.parametrize("name", LIBRARIES)
def test_c_entry_refuses_shapes_outside_the_design(libraries, operands, name):
    args, _ = operands
    err, out = emulate(libraries[name], *args, n_groups=17)
    assert err == 1 and torch.isnan(out).all()  # cudaErrorInvalidValue, nothing launched
