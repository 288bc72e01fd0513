// Fixed-order segment sum (the graph models' message sums) for sm_90a.
//
// Replaces no Pallas kernel: the JAX package sums graph messages as one-hot
// contractions (geometry_rl_tpu/models/common.py: gather_nodes, scatter_sum),
// which XLA evaluates in one fixed order. PyTorch's index_add_ on the card sums
// with float atomics, in another order every run; this kernel sums in the
// order a CSR fixes, so a program and its seed give the same bits every run.
//
//   out[b, m, f] = sum over k in offsets[m] .. offsets[m + 1] of values[b, perm[k], f]
//
// values [B, E, F] (f32 or bf16), perm [Bp, E] int32 (each env's rows stably
// sorted by destination), offsets [Bp, N + 1] int32, out [B, N, F] in values'
// type; Bp = 1 (one topology for every env, strides 0) or B. One thread owns
// one (segment, column): it adds the segment's rows in perm order into an f32
// register and rounds once to the output type. Neighbouring threads take
// neighbouring columns of one row, so a row's reads coalesce. Empty segments
// write 0. No atomics, no shared memory, no allocation.
//
// Bound: bytes. Each value, perm entry and offset is read once and each output
// written once; one add per value. The kernel is simple first: a segment's rows
// are read by F threads each, which the L1 serves, and a long segment (the node
// padded kNN edges point to) keeps its threads longer than the rest.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const T* __restrict__ values, const int* __restrict__ perm, const int* __restrict__ offsets,
    T* __restrict__ out, long long total, int E, int N, int F, int perm_stride, int offsets_stride) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int f = static_cast<int>(i % F);
  const long long seg = i / F;
  const int m = static_cast<int>(seg % N);
  const long long b = seg / N;
  const int* off = offsets + b * offsets_stride;
  const int* pm = perm + b * perm_stride;
  const T* v = values + b * static_cast<long long>(E) * F + f;
  const int k1 = off[m + 1];
  float acc = 0.0f;
  for (int k = off[m]; k < k1; ++k) acc += to_float(v[static_cast<long long>(pm[k]) * F]);
  out[i] = from_float<T>(acc);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Returns the launch's cudaError_t (0 = launched).
extern "C" int segment_sum_launch(const void* values, const void* perm, const void* offsets, void* out, int dtype,
                                  int B, int E, int N, int F, int perm_stride, int offsets_stride,
                                  cudaStream_t stream) {
  const long long total = static_cast<long long>(B) * N * F;
  if (total == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const int* p = static_cast<const int*>(perm);
  const int* o = static_cast<const int*>(offsets);
  if (dtype == 0) {
    segment_sum_kernel<float><<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(values), p, o, static_cast<float*>(out), total, E, N, F, perm_stride, offsets_stride);
  } else if (dtype == 1) {
    segment_sum_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(values), p, o, static_cast<__nv_bfloat16*>(out), total, E, N, F,
        perm_stride, offsets_stride);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
