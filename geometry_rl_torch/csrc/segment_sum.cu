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
// type; Bp = 1 (one topology for every env, strides 0) or B. Each (segment,
// column) adds its rows in perm order, one after the other, into an f32
// register that starts at 0.0f, and rounds once to the output type; an empty
// segment writes 0. Rows whose index falls in no segment are never read. No
// atomics, no allocation, no host read: a CUDA graph can capture a launch.
//
// Bound: bytes. Each value, perm entry and offset is read once and each output
// written once; one f32 add per value is far below the card's rate. What held
// the first design (one thread per (segment, column)) at 28-51% of that bound:
//   - a thread carried 2 bytes (one bf16 column), behind a chain of dependent
//     reads (offsets, then perm, then the value), so a full wave of the card
//     had ~0.5 MB in flight where ~3.4 MB keep 3.35 TB/s busy;
//   - rows were balanced by segment: the padded kNN edges of small rigid
//     shapes all point at node 0, so one segment per env held 81 rows while
//     its 31 neighbours held 0-1, and those threads set the tail.
// This design (route 0, "vec16"):
//   - balances by rows: one CTA owns one (env, segment group, column tile)
//     and walks its group's segments in order, each segment's rows in perm
//     order. An env's segments fall into `groups` runs of whole segments with
//     about equal rows (groups = 1 where the envs alone fill the card), so each
//     CTA streams about (offsets[N] - offsets[0]) / groups rows, and each row
//     of a tile is read once. A segment is summed by one thread whatever the
//     groups, so they cannot change a bit;
//   - reads the env's offsets and perm into shared memory once, before any row;
//   - keeps rows in flight through asynchronous copies: one elected thread of
//     a producer warp issues a 1-D TMA bulk copy (cp.async.bulk) per row into
//     a ring of `stages` stages of `stage_rows` rows; it arrives once on a
//     stage's "full" mbarrier, raising the bytes of all its rows, then issues
//     their copies; consumer warps add the stage's rows and release it through
//     its "empty" mbarrier (one arrival a warp), so the next rows arrive while
//     the current ones are added;
//   - gives each consumer thread 16 bytes of the row (8 bf16 or 4 f32
//     columns): it adds them into f32 registers, in order, and stores 16 bytes
//     of each finished segment.
// What sets the pace, measured on the H100 (kernel_bench.py --rows): a CTA's
// row stream is serial, a fixed cost per row and per segment store whatever
// the ring's depth, the number of producers, the copy instruction (bulk
// copies, 16-byte cp.async or plain loads into registers) or the rows a stage.
// At 90-120 rows a CTA that chain, not the bytes, set the small calls' time;
// segment groups shorten it.
// A 16-byte copy needs 16-byte aligned rows and pointers. Route 1 ("scalar")
// takes the rest (a row not a multiple of 16 bytes, a values view with an odd
// storage offset): the same walk of whole envs, one column per thread, four
// rows' loads in flight before their adds, in the same order. The wrapper
// (models/segment.py, `launch_plan`) picks the route, the column tile, the
// groups, the ring and the shared memory; this file checks them and launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Shared memory, mbarriers and the bulk copy, in PTX. The CPU emulation test
// (tests/test_torch_segment_sum_emulation.py) defines SEGMENT_SUM_STAND_IN and
// supplies dynamic_smem, the mbar_* functions and bulk_row on the host.
#if !defined(SEGMENT_SUM_STAND_IN)

__device__ __forceinline__ unsigned char* dynamic_smem() {
  extern __shared__ __align__(128) unsigned char smem[];
  return smem;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Arrives on `bar` and raises the bytes its phase waits for by `bytes`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Spins until the phase of parity `parity` has completed. A wait past ~2^24
// tries (seconds) traps, so a broken protocol ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  for (uint32_t tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (tries > (1u << 24)) __trap();
  }
}

// One row slice: `bytes` (a multiple of 16) from global `src` into shared
// `dst` (both 16-byte aligned); the copy completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_row(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

#endif

// 16 bytes of T <-> kN f32 accumulators
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void add(float* acc, uint4 r) {
    acc[0] += __uint_as_float(r.x);
    acc[1] += __uint_as_float(r.y);
    acc[2] += __uint_as_float(r.z);
    acc[3] += __uint_as_float(r.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* acc) {
    return make_uint4(__float_as_uint(acc[0]), __float_as_uint(acc[1]), __float_as_uint(acc[2]),
                      __float_as_uint(acc[3]));
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  // a bf16 is the high half of the f32 with the same value
  __device__ __forceinline__ static void add2(float* acc, uint32_t w) {
    acc[0] += __uint_as_float(w << 16);
    acc[1] += __uint_as_float(w & 0xffff0000u);
  }
  __device__ __forceinline__ static void add(float* acc, uint4 r) {
    add2(acc, r.x);
    add2(acc + 2, r.y);
    add2(acc + 4, r.z);
    add2(acc + 6, r.w);
  }
  __device__ __forceinline__ static uint32_t pack2(const float* acc) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[0]))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(acc[1]))) << 16);
  }
  __device__ __forceinline__ static uint4 pack(const float* acc) {
    return make_uint4(pack2(acc), pack2(acc + 2), pack2(acc + 4), pack2(acc + 6));
  }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __uint_as_float(static_cast<uint32_t>(__bfloat16_as_ushort(v)) << 16);
}
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kWarp = 32;
constexpr int kMaxTileBytes = 4096;                                         // the plan's widest tile
constexpr int kVec16MaxThreads = kWarp * (kMaxTileBytes / 16 / kWarp + 1);  // 8 consumer warps + the producer
constexpr int kScalarMaxThreads = 256;

__host__ __device__ constexpr int ring_offset(int stages) { return (16 * stages + 127) / 128 * 128; }

__host__ __device__ constexpr long long vec16_smem_bytes(int stages, int stage_rows, int tile_bytes, int E, int N) {
  return ring_offset(stages) + static_cast<long long>(stages) * stage_rows * tile_bytes + 4LL * (N + 1 + E);
}

// The env's offsets and perm into shared memory, by every thread of the CTA.
__device__ __forceinline__ void load_indices(int* s_off, int* s_perm, const int* __restrict__ offsets,
                                             const int* __restrict__ perm, int E, int N) {
  for (int i = threadIdx.x; i <= N; i += blockDim.x) s_off[i] = offsets[i];
  for (int i = threadIdx.x; i < E; i += blockDim.x) s_perm[i] = perm[i];
}

// The first segment of group g of `groups` (g = groups: N), by one warp: the
// number of segments m whose first row lies before g / groups of the env's
// rows, so the groups' runs of whole segments cover 0..N-1 once each, in
// order, whatever the offsets.
__device__ __forceinline__ int group_start(const int* s_off, int N, int g, int groups, int lane) {
  if (g <= 0) return 0;
  if (g >= groups) return N;
  const long long target = static_cast<long long>(max(0, s_off[N] - s_off[0])) * g / groups;
  int count = 0;
  for (int m = lane; m < N; m += kWarp) count += s_off[m] - s_off[0] < target;
#pragma unroll
  for (int d = kWarp / 2; d > 0; d /= 2) count += __shfl_xor_sync(0xffffffffu, count, d);
  return count;
}

// Route 0. Grid: B x groups x column tiles, env-major, then group-major.
// Block: the tile's consumer warps (16 bytes a thread), then one producer
// warp. Shared memory: `stages` full and empty mbarriers, the ring of
// `stages` x `stage_rows` row slices of `tile` columns, the env's offsets and
// perm. The producer and every consumer count the same stream of rows (the
// group's segments in order, each segment's rows in perm order), so row i of
// the stream sits in slot i % stage_rows of stage (i / stage_rows) % stages.
template <typename T>
__global__ void __launch_bounds__(kVec16MaxThreads) segment_sum_kernel(
    const T* __restrict__ values, const int* __restrict__ perm, const int* __restrict__ offsets, T* __restrict__ out,
    int E, int N, int F, int perm_stride, int offsets_stride, int tile, int tiles, int groups, int stages,
    int stage_rows) {
  constexpr int kVec = Vec16<T>::kN;
  unsigned char* smem = dynamic_smem();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  const int tile_bytes = tile * static_cast<int>(sizeof(T));
  const long long stage_bytes = static_cast<long long>(stage_rows) * tile_bytes;
  unsigned char* ring = smem + ring_offset(stages);
  int* s_off = reinterpret_cast<int*>(ring + stages * stage_bytes);
  int* s_perm = s_off + N + 1;
  __shared__ int s_range[2];

  const int b = blockIdx.x / (groups * tiles);
  const int g = blockIdx.x / tiles % groups;
  const int col0 = (blockIdx.x % tiles) * tile;
  const uint32_t bytes = static_cast<uint32_t>(min(tile, F - col0)) * sizeof(T);  // the last tile may be narrower
  const int consumer_warps = blockDim.x / kWarp - 1;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;

  load_indices(s_off, s_perm, offsets + static_cast<long long>(b) * offsets_stride,
               perm + static_cast<long long>(b) * perm_stride, E, N);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);                // the producer's arrival with the stage's bytes
      mbar_init(&empty[s], consumer_warps);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (warp == consumer_warps) {  // the group's segments, by the producer warp
    const int lo = group_start(s_off, N, g, groups, lane), hi = group_start(s_off, N, g + 1, groups, lane);
    if (lane == 0) s_range[0] = lo, s_range[1] = hi;
  }
  __syncthreads();
  const int m_lo = s_range[0], m_hi = s_range[1];

  if (warp == consumer_warps) {  // the producer: one thread issues every row's copy, in the consumers' order
    if (lane == 0) {
      int left = 0;  // the stream's rows not yet issued
      for (int m = m_lo; m < m_hi; ++m) left += max(0, s_off[m + 1] - s_off[m]);
      const T* src = values + static_cast<long long>(b) * E * F + col0;
      int stage = 0, slot = 0;
      uint32_t phase = 0;
      for (int m = m_lo; m < m_hi; ++m) {
        const int k1 = s_off[m + 1];
        for (int k = s_off[m]; k < k1; ++k, --left) {
          if (slot == 0) {
            mbar_wait(&empty[stage], phase ^ 1);  // the first round passes: the ring starts empty
            mbar_arrive_expect_tx(&full[stage], static_cast<uint32_t>(min(stage_rows, left)) * bytes);
          }
          bulk_row(ring + stage * stage_bytes + slot * tile_bytes, src + static_cast<long long>(s_perm[k]) * F, bytes,
                   &full[stage]);
          if (++slot == stage_rows) {
            slot = 0;
            if (++stage == stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // a consumer thread owns bytes [16 t, 16 t + 16) of the tile
  const int t = threadIdx.x;
  const bool active = static_cast<uint32_t>(t) * 16 < bytes;
  T* dst = out + static_cast<long long>(b) * N * F + col0 + t * kVec;
  const unsigned char* mine = ring + 16 * t;
  int stage = 0, slot = 0;
  uint32_t phase = 0;
  for (int m = m_lo; m < m_hi; ++m) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.0f;
    const int k1 = s_off[m + 1];
    for (int k = s_off[m]; k < k1; ++k) {
      if (slot == 0) mbar_wait(&full[stage], phase);
      if (active) Vec16<T>::add(acc, *reinterpret_cast<const uint4*>(mine + stage * stage_bytes + slot * tile_bytes));
      if (++slot == stage_rows) {
        __syncwarp();  // every lane has read the stage before the warp releases it
        if (lane == 0) mbar_arrive(&empty[stage]);
        slot = 0;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (active) *reinterpret_cast<uint4*>(dst + static_cast<long long>(m) * F) = Vec16<T>::pack(acc);
  }
}

// Route 1. Grid: B x column tiles, env-major; one column per thread. Shared
// memory: the env's offsets, its perm.
template <typename T>
__global__ void __launch_bounds__(kScalarMaxThreads) segment_sum_scalar_kernel(
    const T* __restrict__ values, const int* __restrict__ perm, const int* __restrict__ offsets, T* __restrict__ out,
    int E, int N, int F, int perm_stride, int offsets_stride, int tile, int tiles) {
  int* s_off = reinterpret_cast<int*>(dynamic_smem());
  int* s_perm = s_off + N + 1;
  const int b = blockIdx.x / tiles;
  const int col = (blockIdx.x % tiles) * tile + static_cast<int>(threadIdx.x);
  load_indices(s_off, s_perm, offsets + static_cast<long long>(b) * offsets_stride,
               perm + static_cast<long long>(b) * perm_stride, E, N);
  __syncthreads();
  if (static_cast<int>(threadIdx.x) >= tile || col >= F) return;
  const T* src = values + static_cast<long long>(b) * E * F + col;
  T* dst = out + static_cast<long long>(b) * N * F + col;
  for (int m = 0; m < N; ++m) {
    const int k1 = s_off[m + 1];
    int k = s_off[m];
    float acc = 0.0f;
    for (; k + 4 <= k1; k += 4) {  // four loads in flight, then their adds in order
      const float v0 = to_float(src[static_cast<long long>(s_perm[k]) * F]);
      const float v1 = to_float(src[static_cast<long long>(s_perm[k + 1]) * F]);
      const float v2 = to_float(src[static_cast<long long>(s_perm[k + 2]) * F]);
      const float v3 = to_float(src[static_cast<long long>(s_perm[k + 3]) * F]);
      acc += v0;
      acc += v1;
      acc += v2;
      acc += v3;
    }
    for (; k < k1; ++k) acc += to_float(src[static_cast<long long>(s_perm[k]) * F]);
    dst[static_cast<long long>(m) * F] = from_float<T>(acc);
  }
}

template <typename K>
int set_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <typename T>
int launch(const void* values, const int* perm, const int* offsets, void* out, int B, int E, int N, int F,
           int perm_stride, int offsets_stride, int route, int tile, int groups, int stages, int stage_rows, int threads,
           int smem, cudaStream_t stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (tile <= 0 || groups <= 0 || threads <= 0 || threads % kWarp || smem < 0) return invalid;
  const int tiles = (F + tile - 1) / tile;
  const long long grid = static_cast<long long>(B) * groups * tiles;
  if (grid > 0x7fffffffLL) return invalid;
  const T* v = static_cast<const T*>(values);
  T* o = static_cast<T*>(out);
  if (route == 0) {
    const long long tile_bytes = static_cast<long long>(tile) * sizeof(T);
    const bool aligned = reinterpret_cast<uintptr_t>(values) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (!aligned || tile_bytes % 16 || tile_bytes > kMaxTileBytes || (static_cast<long long>(F) * sizeof(T)) % 16 ||
        stages < 1 || stage_rows < 1 || threads != kWarp * ((tile_bytes / 16 + kWarp - 1) / kWarp + 1) ||
        smem < vec16_smem_bytes(stages, stage_rows, static_cast<int>(tile_bytes), E, N))
      return invalid;
    if (const int err = set_smem(segment_sum_kernel<T>, smem)) return err;
    segment_sum_kernel<T><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
        v, perm, offsets, o, E, N, F, perm_stride, offsets_stride, tile, tiles, groups, stages, stage_rows);
  } else if (route == 1) {
    if (groups != 1 || threads > kScalarMaxThreads || threads < (tile < F ? tile : F) || smem < 4LL * (N + 1 + E))
      return invalid;
    if (const int err = set_smem(segment_sum_scalar_kernel<T>, smem)) return err;
    segment_sum_scalar_kernel<T><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
        v, perm, offsets, o, E, N, F, perm_stride, offsets_stride, tile, tiles);
  } else {
    return invalid;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. route: 0 = vec16 (16 bytes a consumer thread
// through TMA bulk copies), 1 = scalar. tile: columns per CTA; groups: CTAs
// per env and tile, each summing a run of whole segments (1 on the scalar
// route); stages and stage_rows: the vec16 route's ring; threads (on the vec16
// route: the tile's consumer warps, then the producer warp) and smem: the
// block's size and dynamic shared memory bytes, as the wrapper's launch plan
// gives them (checked here). Returns the launch's cudaError_t (0 = launched,
// or nothing to write).
extern "C" int segment_sum_launch(const void* values, const void* perm, const void* offsets, void* out, int dtype,
                                  int B, int E, int N, int F, int perm_stride, int offsets_stride, int route, int tile,
                                  int groups, int stages, int stage_rows, int threads, int smem, cudaStream_t stream) {
  if (B < 0 || E < 0 || N < 0 || F < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(B) * N * F == 0) return 0;
  const int* p = static_cast<const int*>(perm);
  const int* o = static_cast<const int*>(offsets);
  if (dtype == 0)
    return launch<float>(values, p, o, out, B, E, N, F, perm_stride, offsets_stride, route, tile, groups, stages,
                         stage_rows, threads, smem, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(values, p, o, out, B, E, N, F, perm_stride, offsets_stride, route, tile, groups,
                                 stages, stage_rows, threads, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
