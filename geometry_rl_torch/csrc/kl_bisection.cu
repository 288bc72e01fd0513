// The TRPL KL projection's bisection for its dual variable eta, for sm_90a.
//
// Replaces no Pallas kernel: the JAX package bisects with XLA elementwise ops,
// and the port's plain version (rl/projections/kl.py, _solve_eta_plain) runs
// 60 rounds of ~21 small PyTorch ops each, 1,280 launches a call for a few
// microseconds of arithmetic. This kernel does the whole solve in one launch.
//
// Per row r of var, old_var [rows, K] (f32, contiguous) and eps [rows]
// (f32, stride eps_stride: 1, or 0 for one bound broadcast to every row):
//
//   c(x)  = 0.5 * sum_k (p_k / o_k - 1 - log(p_k / o_k)) - eps,
//   p_k   = (1 + x) / (1 / v_k + x / o_k)          (v = var[r], o = old_var[r])
//   lo, hi = 0, eta_max;  `iters` rounds of
//     mid = expm1(0.5 * (log1p(lo) + log1p(hi)));  if c(mid) > 0: lo = mid, else hi = mid
//   eta[r] = c(0) > 0 ? 0.5 * (lo + hi) : 0
//
// One thread a row; the row's reciprocal variances, its old variances, eps,
// lo and hi stay in registers through every round. The result is the plain
// version's, bit for bit, on the card:
//   - every operation is the one PyTorch's separate ops take, in their order,
//     each rounded where theirs is: __fadd_rn / __fsub_rn / __fmul_rn /
//     __fdiv_rn are IEEE and never contracted into an FMA, whatever the
//     library's flags; logf, log1pf and expm1f are the CUDA math library's, as
//     PyTorch's kernels call them;
//   - 1 / v is computed once: the plain version's `1.0 / var` gives the same
//     bits every round; likewise the log1p of a bound is kept until it moves;
//   - the K terms are summed in the order PyTorch's reduction takes over a
//     contiguous last axis of width K <= 16 (`torch_order_sum`);
//   - a NaN compares false, so a row whose c(0) is NaN gets eta 0, and a NaN
//     in a later round moves hi, as the plain version's torch.where does.
// Bound: latency. A row's rounds are one dependent chain (two math-library
// calls, three IEEE divisions and a K-term sum on it a round), while a call of
// 1000 rows moves 52 KB. Summed from each operation's latency on one thread
// (chip_smoke.py `op_latency_ns`), 60 rounds at K = 6 take at least ~11 us on
// an H100; one row takes ~50 us there, as does a call of 1000 rows (the gap
// not yet broken down).
// No allocation, no host read: a CUDA graph can capture a launch.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 16;     // the widest row held in registers, no spill (the wrapper's KERNEL_MAX_K)
constexpr int kThreads = 64;  // rows a block

__host__ __device__ constexpr int last_pow2(int k) { return k < 2 ? 1 : 2 * last_pow2(k / 2); }

// x[0] + ... + x[K-1] as PyTorch's CUDA reduction (ATen/native/cuda/Reduce.cuh)
// adds a contiguous last axis of width K <= 32: W = the largest power of two
// <= K threads share the axis, thread t holds x[t] + x[t + W] (x[t] alone
// where t + W >= K), and a warp shuffle with offsets W/2, W/4, ..., 1 adds
// thread t + offset into thread t: for W = 4, (s0 + s2) + (s1 + s3).
template <int K>
__device__ __forceinline__ float torch_order_sum(const float (&x)[K]) {
  constexpr int W = last_pow2(K);
  float s[W];
#pragma unroll
  for (int t = 0; t < W; ++t) s[t] = t + W < K ? __fadd_rn(x[t], x[t + W]) : x[t];
#pragma unroll
  for (int offset = W / 2; offset > 0; offset /= 2)
#pragma unroll
    for (int t = 0; t < offset; ++t) s[t] = __fadd_rn(s[t], s[t + offset]);
  return s[0];
}

// c(x) > 0: the projection at eta = x still lies outside the KL ball
template <int K>
__device__ __forceinline__ bool violated(float x, const float (&inv_var)[K], const float (&old)[K], float eps) {
  const float a = __fadd_rn(1.0f, x);  // (1 + eta)
  float terms[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float p = __fdiv_rn(a, __fadd_rn(inv_var[k], __fdiv_rn(x, old[k])));  // _interp_var
    const float ratio = __fdiv_rn(p, old[k]);                                    // _kl_cov_diag
    terms[k] = __fsub_rn(__fsub_rn(ratio, 1.0f), logf(ratio));
  }
  return __fsub_rn(__fmul_rn(0.5f, torch_order_sum<K>(terms)), eps) > 0.0f;
}

template <int K>
__global__ void __launch_bounds__(kThreads) kl_bisection_kernel(const float* __restrict__ var,
                                                                 const float* __restrict__ old_var,
                                                                 const float* __restrict__ eps, long long eps_stride,
                                                                 float* __restrict__ eta, long long rows, int iters,
                                                                 float eta_max) {
  const long long r = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (r >= rows) return;
  float inv_var[K], old[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    inv_var[k] = __fdiv_rn(1.0f, var[r * K + k]);
    old[k] = old_var[r * K + k];
  }
  const float bound = eps[r * eps_stride];
  const bool needs_proj = violated<K>(0.0f, inv_var, old, bound);
  float lo = 0.0f, hi = eta_max;
  float log_lo = log1pf(lo), log_hi = log1pf(hi);
  for (int i = 0; i < iters; ++i) {
    const float mid = expm1f(__fmul_rn(0.5f, __fadd_rn(log_lo, log_hi)));
    const bool gt = violated<K>(mid, inv_var, old, bound);  // still violating: a larger eta
    const float log_mid = log1pf(mid);
    if (gt) {
      lo = mid;
      log_lo = log_mid;
    } else {
      hi = mid;
      log_hi = log_mid;
    }
  }
  eta[r] = needs_proj ? __fmul_rn(0.5f, __fadd_rn(lo, hi)) : 0.0f;
}

template <int K>
int launch(const float* var, const float* old_var, const float* eps, long long eps_stride, float* eta, long long rows,
           int iters, float eta_max, cudaStream_t stream) {
  const long long grid = (rows + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  kl_bisection_kernel<K><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(var, old_var, eps, eps_stride, eta,
                                                                                 rows, iters, eta_max);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(int k, const float* var, const float* old_var, const float* eps, long long eps_stride, float* eta,
             long long rows, int iters, float eta_max, cudaStream_t stream) {
  if (k == K) return launch<K>(var, old_var, eps, eps_stride, eta, rows, iters, eta_max, stream);
  if constexpr (K < kMaxK) {
    return dispatch<K + 1>(k, var, old_var, eps, eps_stride, eta, rows, iters, eta_max, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// var, old_var [rows, K] f32 contiguous, eps [rows] f32 with stride eps_stride
// (0 or 1), eta [rows] f32, all on the card; 1 <= K <= 16. Launches on
// `stream` and returns the launch's cudaError_t (0 = launched, or no rows).
extern "C" int kl_bisection_launch(const void* var, const void* old_var, const void* eps, long long eps_stride,
                                   void* eta, long long rows, int K, int iters, float eta_max, cudaStream_t stream) {
  if (rows < 0 || K < 1 || K > kMaxK || iters < 0 || (eps_stride != 0 && eps_stride != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0) return 0;
  return dispatch<1>(K, static_cast<const float*>(var), static_cast<const float*>(old_var),
                     static_cast<const float*>(eps), eps_stride, static_cast<float*>(eta), rows, iters, eta_max,
                     stream);
}
