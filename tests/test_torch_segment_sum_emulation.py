"""The CUDA source of the segment sum, run on the CPU.

`csrc/segment_sum.cu` is compiled by the host C++ compiler against a small
stand-in for the CUDA runtime: each block runs as its threads (std::thread),
one block after another, with a std::barrier for __syncthreads() and one per
warp for __syncwarp() and its shuffles; the stand-in's mbarriers keep the
PTX's phase, pending arrivals and transaction bytes in one 64-bit word, and
its bulk copy copies the row and completes its bytes on the barrier.
Launched with the plans of `models/segment.launch_plan`, both routes are held
bit for bit against the plain version: this checks the kernel's walk, its
segment groups, its ring of stages and their parities, its tiles and its
indexing where there is no card. What the GPU compiler and the hardware make
of it is the card's to show (tests/test_torch_cuda.py, chip_smoke.py).
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
from geometry_rl_torch.graphs.rigid import knn_graph_batch
from geometry_rl_torch.graphs.types import CSR, csr_from_index
from geometry_rl_torch.models.segment import KERNEL_ARGTYPES, KERNEL_DTYPES, ROUTES, launch_plan, segment_sum_ref

LAUNCH = re.compile(r"(segment_sum\w*_kernel<T>)<<<(.*?)>>>\(")

CUDA_BF16_STAND_IN = r"""
#pragma once
#include <cstdint>
#include <cstring>
namespace {  // internal linkage: no symbol meets another emulation's in one process
struct __nv_bfloat16 { unsigned short bits; };
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
inline __nv_bfloat16 __float2bfloat16_rn(float f) {  // round to nearest even, as the card and torch
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<unsigned short>((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
}  // namespace
"""

CUDA_RUNTIME_STAND_IN = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
// internal linkage: the cloth kernels' stand-in (tests/test_torch_cloth_kernel_emulation.py)
// defines some of the same names, and a test process may load both libraries
namespace {
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
inline float __uint_as_float(uint32_t u) { float f; std::memcpy(&f, &u, 4); return f; }
inline uint32_t __float_as_uint(float f) { uint32_t u; std::memcpy(&u, &f, 4); return u; }
using std::max;
using std::min;
struct Index { unsigned x; };
inline thread_local Index threadIdx, blockIdx, blockDim;
using cudaStream_t = void*;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) { return cudaSuccess; }
inline int cudaGetLastError() { return 0; }

inline thread_local unsigned char* block_smem;
inline thread_local std::barrier<>* block_barrier;
inline thread_local std::barrier<>* warp_barrier;
inline thread_local int* warp_table;
inline void __syncthreads() { block_barrier->arrive_and_wait(); }
inline void __syncwarp() { warp_barrier->arrive_and_wait(); }
inline int __shfl_xor_sync(unsigned, int v, int lane_mask) {  // through a table of the warp's 32 lanes
  const int lane = threadIdx.x % 32;
  warp_table[lane] = v;
  __syncwarp();
  const int other = warp_table[lane ^ lane_mask];
  __syncwarp();
  return other;
}
inline unsigned char* dynamic_smem() { return block_smem; }

// an mbarrier: bit 63 the phase, bits 48-62 the expected arrivals, 32-47 the
// pending ones, 0-31 the transaction bytes still to come (signed)
inline uint64_t mbar_pack(uint64_t phase, uint64_t expected, uint64_t pending, int32_t tx) {
  return (phase << 63) | (expected << 48) | (pending << 32) | static_cast<uint32_t>(tx);
}
inline void mbar_update(uint64_t* bar, int arrivals, int32_t tx_delta) {
  uint64_t old = __atomic_load_n(bar, __ATOMIC_ACQUIRE), next;
  do {
    uint64_t phase = old >> 63, expected = (old >> 48) & 0x7fff, pending = (old >> 32) & 0xffff;
    int32_t tx = static_cast<int32_t>(old & 0xffffffffu) + tx_delta;
    if (pending < static_cast<uint64_t>(arrivals)) std::abort();  // more arrivals than the phase expects
    if (tx < 0) std::abort();  // a copy's bytes beyond those its phase was told to expect
    pending -= arrivals;
    if (pending == 0 && tx == 0) phase ^= 1, pending = expected;
    next = mbar_pack(phase, expected, pending, tx);
  } while (!__atomic_compare_exchange_n(bar, &old, next, false, __ATOMIC_ACQ_REL, __ATOMIC_ACQUIRE));
}
inline void mbar_init(uint64_t* bar, uint32_t count) { __atomic_store_n(bar, mbar_pack(0, count, count, 0), __ATOMIC_RELEASE); }
inline void mbar_init_fence() { __atomic_thread_fence(__ATOMIC_SEQ_CST); }
inline void mbar_arrive(uint64_t* bar) { mbar_update(bar, 1, 0); }
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) { mbar_update(bar, 1, static_cast<int32_t>(bytes)); }
inline void mbar_wait(uint64_t* bar, uint32_t parity) {  // a broken protocol aborts after a minute, as __trap
  const auto start = std::chrono::steady_clock::now();
  while ((__atomic_load_n(bar, __ATOMIC_ACQUIRE) >> 63) == parity) {
    if (std::chrono::steady_clock::now() - start > std::chrono::seconds(60)) std::abort();
    std::this_thread::yield();
  }
}
inline void bulk_row(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {  // copies, then completes its bytes
  if (bytes % 16 || reinterpret_cast<uintptr_t>(dst) % 16 || reinterpret_cast<uintptr_t>(src) % 16) std::abort();
  std::memcpy(dst, src, bytes);
  mbar_update(bar, 0, -static_cast<int32_t>(bytes));
}

template <class Kernel, class... Args>
void emulated_launch(Kernel kernel, unsigned grid, int block, int smem, cudaStream_t, Args... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::unique_ptr<unsigned char, void (*)(void*)> buffer(
        static_cast<unsigned char*>(std::aligned_alloc(128, (smem + 127) / 128 * 128 + 128)), std::free);
    std::barrier<> barrier(block);
    std::vector<std::unique_ptr<std::barrier<>>> warps;
    for (int w = 0; w < block / 32; ++w) warps.emplace_back(new std::barrier<>(32));
    std::vector<int> tables(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t, blockIdx.x = b, blockDim.x = block;
        block_smem = buffer.get(), block_barrier = &barrier, warp_barrier = warps[t / 32].get();
        warp_table = &tables[t / 32 * 32];
        kernel(args...);
      });
    for (auto& thread : threads) thread.join();
  }
}
}  // namespace
"""


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler")
    build = tmp_path_factory.mktemp("segment_sum_emulation")
    (build / "cuda_runtime.h").write_text(CUDA_RUNTIME_STAND_IN)
    (build / "cuda_bf16.h").write_text(CUDA_BF16_STAND_IN)
    source = open(f"{CSRC_DIR}/segment_sum.cu").read()
    source, launches = LAUNCH.subn(r"emulated_launch(\1, \2, ", source)
    assert launches == len(ROUTES), "a launch line changed; update LAUNCH"
    (build / "segment_sum.cu").write_text(source)
    out = build / "libsegment_sum.so"
    cmd = [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-Wno-unknown-pragmas", "-DSEGMENT_SUM_STAND_IN",
           f"-I{build}", "-o", str(out), "-x", "c++", str(build / "segment_sum.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip(f"the host compiler lacks C++20 <barrier>: {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    fn = ctypes.CDLL(str(out)).segment_sum_launch
    fn.argtypes, fn.restype = KERNEL_ARGTYPES, ctypes.c_int
    return fn


def emulate(fn, values, csr, sms=132, plan=None):
    """The kernel on CPU tensors with the wrapper's plan (or `plan`): (error, out)."""
    B, E, F = values.shape
    n, Bp = csr.num_segments, csr.perm.shape[0]
    out = torch.full((B, n, F), float("nan"), dtype=values.dtype)
    plan = plan or launch_plan(B, E, n, F, values.dtype, values.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0, sms)
    stride = 0 if Bp == 1 else 1
    err = fn(values.data_ptr(), csr.perm.data_ptr(), csr.offsets.data_ptr(), out.data_ptr(), KERNEL_DTYPES[values.dtype],
             B, E, n, F, stride * E, stride * (n + 1), ROUTES.index(plan.route), plan.tile, plan.groups, plan.stages,
             plan.stage_rows, plan.threads, plan.smem, None)
    return err, out, plan


def offset_view(values, offset):
    """`values` copied into a contiguous view that starts `offset` elements into its storage."""
    buf = torch.zeros(values.numel() + offset, dtype=values.dtype)
    view = buf[offset:].view(values.shape)
    view.copy_(values)
    return view


def index_with_strays(rng, B, E, n):
    """dst [B, E] into n segments: some segments empty, some indices outside [0, n)."""
    dst = rng.integers(-1, n + 2, (B, E))
    dst[:, : E // 3] = 1  # one long segment per env
    dst[dst == n // 2] = 0  # one segment left empty everywhere
    return torch.as_tensor(dst)


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "odd_offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [1, 3, 64, 1024, 1028])
def test_emulated_kernel_matches_plain_version(kernel, F, dtype, offset):
    """Both routes, per-env and shared CSRs, ragged last tiles: bit for bit."""
    rng = np.random.default_rng(F)
    B, E, n = 3, 14, 6
    values = offset_view(torch.as_tensor(rng.normal(size=(B, E, F)).astype(np.float32)).to(dtype), offset)
    for csr in (csr_from_index(index_with_strays(rng, B, E, n), n), csr_from_index(index_with_strays(rng, 1, E, n), n)):
        err, out, plan = emulate(kernel, values, csr)
        want_vec16 = offset == 0 and F * values.element_size() % 16 == 0
        assert err == 0 and plan.route == ("vec16" if want_vec16 else "scalar")
        assert torch.equal(out, segment_sum_ref(values, csr)), plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_emulated_widest_tile_and_deep_ring(kernel, dtype):
    """One SM's worth of grid: no split, so the widest tile (8 consumer warps
    in f32) and a ring that wraps many times over one 40-row segment, with
    segments that end inside a stage."""
    rng = np.random.default_rng(5)
    B, E, n = 4, 60, 3
    values = torch.as_tensor(rng.normal(size=(B, E, 1024)).astype(np.float32)).to(dtype)
    dst = torch.as_tensor(rng.integers(0, n, (B, E)))
    dst[:, :40] = 2
    csr = csr_from_index(dst, n)
    err, out, plan = emulate(kernel, values, csr, sms=1)
    assert err == 0 and plan.route == "vec16" and plan.tile == 1024 and plan.groups == 1
    assert plan.stages * plan.stage_rows < 40
    assert torch.equal(out, segment_sum_ref(values, csr))


def test_emulated_rigid_knn_csr(kernel):
    """The rigid kNN graphs of shapes with 6 to 32 points: the padded edges pile
    up on node 0 (81 rows of 96 in a 6-point env)."""
    rng = np.random.default_rng(2)
    counts = np.array([6, 32, 11])
    src, dst, _ = knn_graph_batch(rng.normal(size=(3, 32, 3)).astype(np.float32), counts, 3)
    csr = csr_from_index(torch.as_tensor(dst.astype(np.int64)), 32)
    assert (csr.offsets[0, 1] - csr.offsets[0, 0]).item() == 81
    values = torch.randn(3, dst.shape[1], 1024).to(torch.bfloat16)
    err, out, plan = emulate(kernel, values, csr)
    assert err == 0 and plan.route == "vec16"
    assert torch.equal(out, segment_sum_ref(values, csr))


@pytest.mark.parametrize("route", ROUTES)
def test_emulated_no_rows_writes_zeros(kernel, route):
    """E = 0: every segment is empty and writes 0."""
    values = torch.zeros(2, 0, 16)
    csr = csr_from_index(torch.zeros(2, 0, dtype=torch.long), 4)
    plan = launch_plan(2, 0, 4, 16, torch.float32, route == "vec16")
    err, out, _ = emulate(kernel, values, csr, plan=plan)
    assert err == 0 and plan.route == route and torch.equal(out, torch.zeros(2, 4, 16))


def test_c_entry_refuses_a_plan_it_cannot_run(kernel):
    """A vec16 plan for an unaligned view, too few threads, too little shared
    memory, a tile that is not 16 bytes wide or no rows a stage, and a scalar
    plan with segment groups: cudaErrorInvalidValue, nothing launched."""
    values = torch.randn(2, 5, 64)
    csr = CSR(torch.arange(5, dtype=torch.int32)[None], torch.tensor([[0, 2, 5]], dtype=torch.int32))
    plan = launch_plan(2, 5, 2, 64, torch.float32, True)
    for bad_values, bad_plan in ((offset_view(values, 1), plan), (values, plan._replace(threads=plan.threads - 32)),
                                 (values, plan._replace(smem=plan.smem - 4)), (values, plan._replace(tile=3)),
                                 (values, plan._replace(stage_rows=0)),
                                 (values, launch_plan(2, 5, 2, 64, torch.float32, False)._replace(groups=2))):
        err, out, _ = emulate(kernel, bad_values, csr, plan=bad_plan)
        assert err == 1 and torch.isnan(out).all()


def test_emulated_offsets_out_of_order(kernel):
    """Offsets that decrease somewhere (no stable sort makes them): the copies
    and the adds walk the segments as the plain version reads them, so a
    segment whose end lies before its start is empty, with and without segment
    groups."""
    values = torch.randn(2, 8, 64)
    csr = CSR(torch.tensor([[3, 0, 7, 1, 6, 2, 5, 4]], dtype=torch.int32),
              torch.tensor([[1, 5, 3, 8, 8, 6]], dtype=torch.int32))
    for groups in (1, 2, 4):
        plan = launch_plan(2, 8, 5, 64, torch.float32, True)._replace(groups=groups)
        err, out, _ = emulate(kernel, values, csr, plan=plan._replace(grid=2 * groups))
        assert err == 0 and torch.equal(out, segment_sum_ref(values, csr)) and not out[:, 1].any(), groups


@pytest.mark.parametrize("groups", [2, 3, 8, 64])
def test_emulated_segment_groups_cover_every_segment_once(kernel, groups):
    """An env's segments split into runs of whole segments by rows: every
    segment summed once, bit for bit, with more groups than segments too
    (groups of no segment write nothing), per-env and shared CSRs, empty
    segments and indices outside [0, N)."""
    rng = np.random.default_rng(groups)
    B, E, n = 3, 40, 7
    values = torch.as_tensor(rng.normal(size=(B, E, 64)).astype(np.float32)).to(torch.bfloat16)
    for csr in (csr_from_index(index_with_strays(rng, B, E, n), n), csr_from_index(index_with_strays(rng, 1, E, n), n)):
        plan = launch_plan(B, E, n, 64, torch.bfloat16, True)._replace(groups=groups)
        err, out, _ = emulate(kernel, values, csr, plan=plan._replace(grid=B * groups))
        assert err == 0 and torch.equal(out, segment_sum_ref(values, csr))
