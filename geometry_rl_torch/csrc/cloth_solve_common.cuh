// Fused XPBD cloth position solve for Hopper (sm_90a): the one device design
// that both kernel files instantiate.
//
// `cloth_solve.cu` (K2's port, `geometry_rl_tpu/sim/pallas_cloth.py:
// cloth_position_solve_tiled`) and `cloth_solve_env.cu` (K1's port,
// `cloth_position_solve`) compute the same solve and differ only in operation
// order, the template parameter `Order`:
//   - kInverse (K2, `_solve_tile`): inv = 1 / max(|d|, 1e-9),
//     lam = -c * mask / denom, x_i += lam * w_i * inv * d;
//   - kNormalizeFirst (K1, `_solve_env`): n = d / max(|d|, 1e-9),
//     lam = -c / denom * mask, x_i += lam * n * w_i.
// For each env, `iterations` XPBD passes of
//   - one compliant distance solve per conflict-free constraint group,
//   - an optional all-pairs particle self-collision pass (Jacobi),
//   - rest-0 attachments corner particle <-> gripper pseudo-particle,
//   - capsule hook contact with Coulomb friction (cloth particles only).
// The public layout is the reference's x [B, PT, 3] (PT = P + G).
//
// What bounds it on this card: neither bytes nor operations. At B = 100 a
// call moves ~1.4 MB and does ~41 MFLOP, under a microsecond of either. Each
// env is one chain of 10 x (12 + 1) dependent passes, and with one CTA per
// SM nothing hides a pass's latency, so the time is that chain. On an H100
// most of a pass is the IEEE sqrt / reciprocal / divide sequence: each
// compiles to a branchy block (a range check around an out-of-line slow
// path) that the compiler does not schedule across, so they run one after
// another. Built with fast-math the same kernel takes under half the time
// (PERF.md).
//
// What the design does about it:
//   - One CTA of 128 threads (4 warps) per env at every B: 100 CTAs at
//     B = 100 on 132 SMs, and dependent passes separated by a barrier over
//     4 warps.
//   - Thread t owns constraint offset[g] + t of every group (groups have at
//     most 128 constraints) and particles t and t + 128 (P + G <= 256).
//   - Constraint data (i and j packed in 16 bits each, rest, this env's
//     mask, and the solve's denominator max(w_i + w_j + alpha, 1e-12),
//     constant for the call) lives in registers for the whole call; the
//     group loop is unrolled to kMaxGroups and predicated on n_groups, so no
//     register array is indexed at run time. The constant denominators take
//     the divisor's half of each divide off the chain. Groups are
//     conflict-free (checked on the host when the env is built), so a thread
//     reads and writes its two particles with no atomics.
//   - That costs registers (~160 a thread, no spills): 3 CTAs fit an SM, so
//     B = 1000 runs in three waves. Capping at 128 registers spills.
//   - Particle state is one float4 (x, y, z, inverse mass) per particle in
//     shared memory: a constraint reads and writes each particle with one
//     16-byte access. prev_x is read only by the hook pass, for the thread's
//     own particles, and stays in its registers.
//   - Attachments and hook contact run as one pass: attachment a touches
//     only corner att[a] and pseudo-particle P + a, contact touches each
//     cloth particle alone, so the thread that owns the corner does its
//     attachment and then its contact with no barrier between (the host
//     checks that att holds distinct cloth indices). 13 barriers per
//     iteration instead of 14.
//   - Self-collision (a separate instantiation, off on the main paths) is a
//     Jacobi pass: each thread sums the corrections of its two particles in
//     registers, a barrier, each applies its own.
//   - IEEE sqrtf and divisions, no fast-math intrinsics.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace cloth {

constexpr int kThreads = 128;                // one CTA per env
constexpr int kMaxGroups = 16;               // distance groups, unrolled
constexpr int kMaxParticles = 2 * kThreads;  // P + G; thread t owns t and t + 128
constexpr uint32_t kNoConstraint = 0xFFFFFFFFu;

enum class Order { kInverse, kNormalizeFirst };  // K2's, K1's

struct SolveArgs {
  const float* x;             // [B, PT, 3]
  const float* prev;          // [B, PT, 3]
  const float* inv_mass;      // [B, PT]
  const float* hanger;        // [B, 3]
  const float* body_w;        // [B, G]
  const int* att_particle;    // [G], distinct cloth indices
  const int* group_i;         // [C]
  const int* group_j;         // [C]
  const float* group_rest;    // [C]
  const float* group_mask;    // [B, C]
  const int* group_offset;    // [n_groups + 1]
  const float* group_compliance;  // [n_groups]
  const float* pair_mask;     // [PT, PT], self-collision only
  const float* active;        // [B, PT], self-collision only
  float* out;                 // [B, PT, 3]
  int P, G, n_groups, c_total, iterations;
  float dt, hook_radius, hook_half_len, friction, self_min_dist;
};

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return sqrtf(a * a + b * b + c * c);
}

// One distance constraint on particles pi, pj (xyz, w = inverse mass);
// denom = max(w_i + w_j + compliance / dt^2, 1e-12), constant for the call.
template <Order kOrder>
__device__ __forceinline__ void distance_constraint(float4& pi, float4& pj, float rest, float mask,
                                                    float denom) {
  const float dx = pi.x - pj.x, dy = pi.y - pj.y, dz = pi.z - pj.z;
  const float dist = norm3(dx, dy, dz);
  if constexpr (kOrder == Order::kInverse) {
    const float inv = 1.0f / fmaxf(dist, 1e-9f);
    const float lam = -(dist - rest) * mask / denom;
    const float li = lam * pi.w * inv, lj = lam * pj.w * inv;
    pi.x += li * dx;
    pi.y += li * dy;
    pi.z += li * dz;
    pj.x -= lj * dx;
    pj.y -= lj * dy;
    pj.z -= lj * dz;
  } else {
    const float nd = fmaxf(dist, 1e-9f);
    const float nx = dx / nd, ny = dy / nd, nz = dz / nd;
    const float lam = -(dist - rest) / denom * mask;
    const float ux = lam * nx, uy = lam * ny, uz = lam * nz;
    pi.x += ux * pi.w;
    pi.y += uy * pi.w;
    pi.z += uz * pi.w;
    pj.x -= ux * pj.w;
    pj.y -= uy * pj.w;
    pj.z -= uz * pj.w;
  }
}

// Rest-0 attachment corner particle p <-> pseudo-particle q (inverse mass
// wb); denom = max(w_p + wb, 1e-12), constant for the call.
template <Order kOrder>
__device__ __forceinline__ void attachment(float4& p, float4& q, float wb, float denom) {
  const float cx = p.x - q.x, cy = p.y - q.y, cz = p.z - q.z;
  const float cn = norm3(cx, cy, cz);
  const float lam = -cn / denom;
  if constexpr (kOrder == Order::kInverse) {
    const float inv = 1.0f / fmaxf(cn, 1e-9f);
    const float lp = lam * p.w * inv, lb = lam * wb * inv;
    p.x += lp * cx;
    p.y += lp * cy;
    p.z += lp * cz;
    q.x -= lb * cx;
    q.y -= lb * cy;
    q.z -= lb * cz;
  } else {
    const float nd = fmaxf(cn, 1e-9f);
    const float ux = lam * (cx / nd), uy = lam * (cy / nd), uz = lam * (cz / nd);
    p.x += ux * p.w;
    p.y += uy * p.w;
    p.z += uz * p.w;
    q.x -= ux * wb;
    q.y -= uy * wb;
    q.z -= uz * wb;
  }
}

// Capsule hook contact along +y from the hanger origin h, with Coulomb
// friction against the displacement since prev.
template <Order kOrder>
__device__ __forceinline__ void hook_contact(float4& p, float3 prev, float3 h, const SolveArgs& a) {
  const float rel1 = p.y - h.y;
  const float y = fminf(fmaxf(rel1, 0.0f), 2.0f * a.hook_half_len);
  const float dx = p.x - h.x, dy = rel1 - y, dz = p.z - h.z;
  const float dist = norm3(dx, dy, dz);
  const float phi = dist - a.hook_radius;
  if (phi < 0.0f) {
    float nx, ny, nz;
    if constexpr (kOrder == Order::kInverse) {
      const float inv = 1.0f / fmaxf(dist, 1e-9f);
      nx = dx * inv, ny = dy * inv, nz = dz * inv;
    } else {
      const float nd = fmaxf(dist, 1e-9f);
      nx = dx / nd, ny = dy / nd, nz = dz / nd;
    }
    const float pen = phi;  // min(phi, 0) with phi < 0
    const float ux = p.x - prev.x, uy = p.y - prev.y, uz = p.z - prev.z;
    const float dn = ux * nx + uy * ny + uz * nz;
    const float tx = ux - dn * nx, ty = uy - dn * ny, tz = uz - dn * nz;
    const float tn = norm3(tx, ty, tz);
    const float scale = fminf(1.0f, a.friction * (-pen) / fmaxf(tn, 1e-9f));
    p.x = p.x + (-pen * nx - scale * tx);
    p.y = p.y + (-pen * ny - scale * ty);
    p.z = p.z + (-pen * nz - scale * tz);
  }
}

// Self-collision contribution of particle q to particle pi's correction.
// Pairs with no violation add nothing: skipping them leaves the sums
// bit-identical for finite inputs and saves their divisions.
template <Order kOrder>
__device__ __forceinline__ void self_pair(float4 pi, float act_i, float4 q, float act_q, float pm,
                                          float min_dist, float3& acc, float& count) {
  const float dx = pi.x - q.x, dy = pi.y - q.y, dz = pi.z - q.z;
  const float ex = dx + 1e-12f, ey = dy + 1e-12f, ez = dz + 1e-12f;
  const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
  const float viol = fmaxf(min_dist - dist, 0.0f) * pm * act_i * act_q;
  if (viol > 0.0f) {
    if constexpr (kOrder == Order::kInverse) {
      const float corr = viol / fmaxf(pi.w + q.w, 1e-12f) * pi.w / fmaxf(dist, 1e-9f);
      acc.x += corr * dx;
      acc.y += corr * dy;
      acc.z += corr * dz;
    } else {
      const float corr = viol / fmaxf(pi.w + q.w, 1e-12f) * pi.w;
      const float nd = fmaxf(dist, 1e-9f);
      acc.x += corr * (dx / nd);
      acc.y += corr * (dy / nd);
      acc.z += corr * (dz / nd);
    }
    count += 1.0f;
  }
}

// The whole solve of env blockIdx.x; launched with kThreads threads.
template <Order kOrder, bool kSelf>
__device__ __forceinline__ void solve(const SolveArgs& a) {
  __shared__ float4 sx[kMaxParticles];
  __shared__ float sact[kSelf ? kMaxParticles : 1];

  const int b = blockIdx.x, t = threadIdx.x;
  const int P = a.P, PT = a.P + a.G, n_groups = a.n_groups;
  const size_t env = static_cast<size_t>(b) * PT;

  // --- own particles t and t + kThreads: state into shared memory, prev
  // (cloth particles only: the hook reads it) into registers. Arrays over s
  // are indexed only in unrolled loops, so they stay in registers ----------
  float3 prev[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int p = t + s * kThreads;
    prev[s] = make_float3(0.f, 0.f, 0.f);
    if (p < PT) {
      const float* xp = a.x + 3 * (env + p);
      sx[p] = make_float4(xp[0], xp[1], xp[2], a.inv_mass[env + p]);
      if constexpr (kSelf) sact[p] = a.active[env + p];
      if (p < P) {
        const float* pp = a.prev + 3 * (env + p);
        prev[s] = make_float3(pp[0], pp[1], pp[2]);
      }
    }
  }
  const float dt2 = a.dt * a.dt;

  // --- constraint data of this thread, in registers for all iterations ----
  uint32_t ij[kMaxGroups];
  float rest[kMaxGroups], mask[kMaxGroups], denom[kMaxGroups];
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    ij[g] = kNoConstraint;
    rest[g] = mask[g] = denom[g] = 0.0f;
    if (g < n_groups) {
      denom[g] = a.group_compliance[g] / dt2;  // alpha, until the barrier below
      const int c = a.group_offset[g] + t;
      if (c < a.group_offset[g + 1]) {
        ij[g] = static_cast<uint32_t>(a.group_i[c]) | (static_cast<uint32_t>(a.group_j[c]) << 16);
        rest[g] = a.group_rest[c];
        mask[g] = a.group_mask[static_cast<size_t>(b) * a.c_total + c];
      }
    }
  }

  // --- attachments owned by this thread: att[k] is t or t + kThreads -------
  int att[2] = {-1, -1};
  float bw[2] = {0.f, 0.f};
  for (int k = 0; k < a.G; ++k) {
    const int p = a.att_particle[k];
    if (p == t) {
      att[0] = k;
      bw[0] = a.body_w[static_cast<size_t>(b) * a.G + k];
    } else if (p == t + kThreads) {
      att[1] = k;
      bw[1] = a.body_w[static_cast<size_t>(b) * a.G + k];
    }
  }
  const float3 h = make_float3(a.hanger[3 * b], a.hanger[3 * b + 1], a.hanger[3 * b + 2]);
  __syncthreads();

  // --- denominators, constant for the call: inverse masses do not change,
  // so each solve's divisor is ready before its numerator ------------------
#pragma unroll
  for (int g = 0; g < kMaxGroups; ++g) {
    if (ij[g] != kNoConstraint) {
      denom[g] = fmaxf(sx[ij[g] & 0xFFFFu].w + sx[ij[g] >> 16].w + denom[g], 1e-12f);
    }
  }
  float att_denom[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    att_denom[s] = att[s] >= 0 ? fmaxf(sx[t + s * kThreads].w + bw[s], 1e-12f) : 1.0f;
  }

  for (int it = 0; it < a.iterations; ++it) {
    // --- distance groups: thread t solves constraint offset[g] + t ---------
#pragma unroll
    for (int g = 0; g < kMaxGroups; ++g) {
      if (g < n_groups) {
        if (ij[g] != kNoConstraint) {
          const int i = ij[g] & 0xFFFFu, j = ij[g] >> 16;
          float4 pi = sx[i], pj = sx[j];
          distance_constraint<kOrder>(pi, pj, rest[g], mask[g], denom[g]);
          sx[i] = pi;
          sx[j] = pj;
        }
        __syncthreads();
      }
    }

    // --- self-collision: Jacobi, every particle reads the same x ----------
    if constexpr (kSelf) {
      const bool own0 = t < PT, own1 = t + kThreads < PT;
      const float4 x0 = own0 ? sx[t] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x1 = own1 ? sx[t + kThreads] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float act0 = own0 ? sact[t] : 0.f, act1 = own1 ? sact[t + kThreads] : 0.f;
      const float* pm0 = a.pair_mask + static_cast<size_t>(t) * PT;
      const float* pm1 = pm0 + static_cast<size_t>(kThreads) * PT;
      float3 acc0 = make_float3(0.f, 0.f, 0.f), acc1 = acc0;
      float count0 = 0.f, count1 = 0.f;
#pragma unroll 4
      for (int q = 0; q < PT; ++q) {
        const float4 xq = sx[q];
        const float act_q = sact[q];
        if (own0) self_pair<kOrder>(x0, act0, xq, act_q, pm0[q], a.self_min_dist, acc0, count0);
        if (own1) self_pair<kOrder>(x1, act1, xq, act_q, pm1[q], a.self_min_dist, acc1, count1);
      }
      __syncthreads();
      if (own0) {
        count0 = fmaxf(count0, 1.0f);
        sx[t] = make_float4(x0.x + acc0.x / count0, x0.y + acc0.y / count0, x0.z + acc0.z / count0, x0.w);
      }
      if (own1) {
        count1 = fmaxf(count1, 1.0f);
        sx[t + kThreads] =
            make_float4(x1.x + acc1.x / count1, x1.y + acc1.y / count1, x1.z + acc1.z / count1, x1.w);
      }
      __syncthreads();
    }

    // --- attachment, then hook contact, of each own cloth particle. All
    // loads come before any store, so the two particles' chains overlap ----
    float4 xp[2], xq[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      if (t + s * kThreads < P) xp[s] = sx[t + s * kThreads];
      if (att[s] >= 0) xq[s] = sx[P + att[s]];
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int p = t + s * kThreads;
      if (p < P) {
        if (att[s] >= 0) {
          attachment<kOrder>(xp[s], xq[s], bw[s], att_denom[s]);
          sx[P + att[s]] = xq[s];
        }
        hook_contact<kOrder>(xp[s], prev[s], h, a);
        sx[p] = xp[s];
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int p = t + s * kThreads;
    if (p < PT) {
      const float4 xp = sx[p];
      float* op = a.out + 3 * (env + p);
      op[0] = xp.x;
      op[1] = xp.y;
      op[2] = xp.z;
    }
  }
}

// Host side: launch `plain` (self-collision off) or `self` on `stream`, one
// CTA per env. Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the design does not take (the Python
// wrapper raises before that, in `check_kernel_limits`).
inline int launch(void (*plain)(SolveArgs), void (*self)(SolveArgs), const SolveArgs& a, int B,
                  void* stream) {
  if (B < 1 || a.n_groups < 0 || a.n_groups > kMaxGroups || a.P < 0 || a.G < 0 ||
      a.P + a.G > kMaxParticles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto* kernel = a.self_min_dist > 0.0f ? self : plain;
  kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace cloth

// The C entry point both kernel files export under their own name, bound
// with ctypes. The argument order is the Python wrapper's.
#define CLOTH_SOLVE_C_ENTRY(entry, plain, self)                                                    \
  extern "C" int entry(                                                                          \
      const float* x, const float* prev, const float* inv_mass, const float* hanger,             \
      const float* body_w, const int* att_particle, const int* group_i, const int* group_j,      \
      const float* group_rest, const float* group_mask, const int* group_offset,                 \
      const float* group_compliance, const float* pair_mask, const float* active, float* out,    \
      int B, int P, int G, int n_groups, int c_total, int iterations, float dt,                  \
      float hook_radius, float hook_half_len, float friction, float self_min_dist,               \
      void* stream) {                                                                            \
    const cloth::SolveArgs a{x, prev, inv_mass, hanger, body_w, att_particle, group_i, group_j,  \
                             group_rest, group_mask, group_offset, group_compliance, pair_mask,  \
                             active, out, P, G, n_groups, c_total, iterations, dt, hook_radius,  \
                             hook_half_len, friction, self_min_dist};                            \
    return cloth::launch(plain, self, a, B, stream);                                             \
  }
