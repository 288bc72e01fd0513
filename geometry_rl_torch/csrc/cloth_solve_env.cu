// XPBD cloth position solve for Hopper (sm_90a), one warp per env.
//
// Replaces `geometry_rl_tpu/sim/pallas_cloth.py:cloth_position_solve`
// (kernel K1, `_kernel` -> `_solve_env`), the one-env-per-program solve that
// the cloth env runs with `use_pallas_solver=True`, twice per control step.
// It computes the same solve as K2 (`cloth_solve.cu`): for each env,
// `iterations` XPBD passes of
//   - one compliant distance solve per conflict-free constraint group,
//   - an optional all-pairs particle self-collision pass (Jacobi),
//   - rest-0 attachments corner particle <-> gripper pseudo-particle,
//   - capsule hook contact with Coulomb friction (cloth particles only),
// in K1's own operation order (`_solve_env`): n = d / max(|d|, 1e-9),
// lam = -c / max(wi + wj + alpha, 1e-12) * mask, dx = lam * n.
// The layout is the reference's x [B, PT, 3] (PT = P + G).
//
// What bounds it on this card: not bytes (about 1.5 MB per call at B = 100)
// but the chain of 10 x (12 + 2) dependent passes per env, each a few
// dependent sqrt/divides deep.
//
// What the design does about it: one env per warp, kEnvsPerCta envs per
// CTA. The constraint topology (i, j, rest) goes into shared memory once per
// CTA and is read by all of its envs; each env keeps x, prev, inverse masses
// and its constraint masks in its own shared slice for all iterations, so
// device memory is touched once on the way in and once on the way out.
// Dependent passes are separated by __syncwarp(), not block barriers: a warp
// walks a group's constraints in strides of 32, and groups are conflict-free
// (checked on the host when the env is built), so no two lanes write the same
// particle and there are no atomics. At B = 100 and 4 envs per CTA the grid is
// only 25 CTAs; the design is meant for many envs per SM. 8 envs per CTA
// measured 4% slower at B = 100 on the H100, so the count is fixed at 4.

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxGroups = 32;
constexpr int kEnvsPerCta = 4;

__global__ void cloth_solve_env_kernel(
    const float* __restrict__ x, const float* __restrict__ prev,
    const float* __restrict__ inv_mass, const float* __restrict__ hanger,
    const float* __restrict__ body_w, const int* __restrict__ att_particle,
    const int* __restrict__ group_i, const int* __restrict__ group_j,
    const float* __restrict__ group_rest, const float* __restrict__ group_mask,
    const int* __restrict__ group_offset, const float* __restrict__ group_compliance,
    const float* __restrict__ pair_mask, const float* __restrict__ active,
    float* __restrict__ out, int B, int P, int G, int n_groups, int c_total,
    int iterations, float dt, float hook_radius, float hook_half_len,
    float friction, float self_min_dist) {
  extern __shared__ float smem[];
  __shared__ int soff[kMaxGroups + 1];
  __shared__ float salpha[kMaxGroups];
  const int PT = P + G;
  const bool self_on = self_min_dist > 0.0f;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kEnvsPerCta + warp;

  // topology, shared by the CTA's envs
  int* si = reinterpret_cast<int*>(smem);    // [c_total]
  int* sj = si + c_total;                    // [c_total]
  float* srest = reinterpret_cast<float*>(sj + c_total);  // [c_total]
  // this warp's env
  const int per_env = 7 * PT + c_total + (self_on ? 3 * PT : 0);
  float* sx = srest + c_total + warp * per_env;  // [PT * 3]
  float* sprev = sx + 3 * PT;                    // [PT * 3]
  float* sw = sprev + 3 * PT;                    // [PT]
  float* smask = sw + PT;                        // [c_total]
  float* sdx = smask + c_total;                  // [PT * 3], self-collision only

  const float dt2 = dt * dt;
  for (int c = threadIdx.x; c < c_total; c += blockDim.x) {
    si[c] = group_i[c];
    sj[c] = group_j[c];
    srest[c] = group_rest[c];
  }
  for (int g = threadIdx.x; g <= n_groups; g += blockDim.x) {
    soff[g] = group_offset[g];
    if (g < n_groups) salpha[g] = group_compliance[g] / dt2;
  }
  __syncthreads();
  if (b >= B) return;  // no block barrier follows

  const float* xb = x + static_cast<size_t>(b) * PT * 3;
  const float* pb = prev + static_cast<size_t>(b) * PT * 3;
  for (int k = lane; k < 3 * PT; k += kWarp) {
    sx[k] = xb[k];
    sprev[k] = pb[k];
  }
  for (int p = lane; p < PT; p += kWarp) sw[p] = inv_mass[static_cast<size_t>(b) * PT + p];
  for (int c = lane; c < c_total; c += kWarp) smask[c] = group_mask[static_cast<size_t>(b) * c_total + c];
  const float hx = hanger[b * 3 + 0], hy = hanger[b * 3 + 1], hz = hanger[b * 3 + 2];
  const float* act_b = self_on ? active + static_cast<size_t>(b) * PT : nullptr;
  __syncwarp();

  for (int it = 0; it < iterations; ++it) {
    // --- distance groups: a lane per constraint, strides of 32 -------------
    for (int g = 0; g < n_groups; ++g) {
      const int c1 = soff[g + 1];
      const float alpha = salpha[g];
      for (int c = soff[g] + lane; c < c1; c += kWarp) {
        const int i = si[c], j = sj[c];
        const float wi = sw[i], wj = sw[j];
        const float dx = sx[3 * i] - sx[3 * j];
        const float dy = sx[3 * i + 1] - sx[3 * j + 1];
        const float dz = sx[3 * i + 2] - sx[3 * j + 2];
        const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
        const float nd = fmaxf(dist, 1e-9f);
        const float nx = dx / nd, ny = dy / nd, nz = dz / nd;
        const float lam = -(dist - srest[c]) / fmaxf(wi + wj + alpha, 1e-12f) * smask[c];
        const float ux = lam * nx, uy = lam * ny, uz = lam * nz;
        sx[3 * i] += ux * wi;
        sx[3 * i + 1] += uy * wi;
        sx[3 * i + 2] += uz * wi;
        sx[3 * j] -= ux * wj;
        sx[3 * j + 1] -= uy * wj;
        sx[3 * j + 2] -= uz * wj;
      }
      __syncwarp();
    }

    // --- self-collision: Jacobi, every particle reads the same x ----------
    if (self_on) {
      for (int p = lane; p < PT; p += kWarp) {
        const float xi = sx[3 * p], yi = sx[3 * p + 1], zi = sx[3 * p + 2];
        const float wi = sw[p];
        const float act_i = act_b[p];
        const float* pm_row = pair_mask + static_cast<size_t>(p) * PT;
        float ax = 0.f, ay = 0.f, az = 0.f, count = 0.f;
        for (int q = 0; q < PT; ++q) {
          const float dx = xi - sx[3 * q], dy = yi - sx[3 * q + 1], dz = zi - sx[3 * q + 2];
          const float ex = dx + 1e-12f, ey = dy + 1e-12f, ez = dz + 1e-12f;
          const float dist = sqrtf(ex * ex + ey * ey + ez * ez);
          const float viol = fmaxf(self_min_dist - dist, 0.0f) * pm_row[q] * act_i * act_b[q];
          const float corr = viol / fmaxf(wi + sw[q], 1e-12f) * wi;
          const float nd = fmaxf(dist, 1e-9f);
          ax += corr * (dx / nd);
          ay += corr * (dy / nd);
          az += corr * (dz / nd);
          count += viol > 0.0f ? 1.0f : 0.0f;
        }
        count = fmaxf(count, 1.0f);
        sdx[3 * p] = ax / count;
        sdx[3 * p + 1] = ay / count;
        sdx[3 * p + 2] = az / count;
      }
      __syncwarp();
      for (int k = lane; k < 3 * PT; k += kWarp) sx[k] += sdx[k];
      __syncwarp();
    }

    // --- attachments: corner particle <-> gripper pseudo-particle ---------
    for (int a = lane; a < G; a += kWarp) {
      const int p = att_particle[a], q = P + a;
      const float wp = sw[p], wb = body_w[b * G + a];
      const float cx = sx[3 * p] - sx[3 * q];
      const float cy = sx[3 * p + 1] - sx[3 * q + 1];
      const float cz = sx[3 * p + 2] - sx[3 * q + 2];
      const float cn = sqrtf(cx * cx + cy * cy + cz * cz);
      const float nd = fmaxf(cn, 1e-9f);
      const float lam = -cn / fmaxf(wp + wb, 1e-12f);
      const float ux = lam * (cx / nd), uy = lam * (cy / nd), uz = lam * (cz / nd);
      sx[3 * p] += ux * wp;
      sx[3 * p + 1] += uy * wp;
      sx[3 * p + 2] += uz * wp;
      sx[3 * q] -= ux * wb;
      sx[3 * q + 1] -= uy * wb;
      sx[3 * q + 2] -= uz * wb;
    }
    __syncwarp();

    // --- hook contact: capsule along +y from the hanger origin ------------
    for (int p = lane; p < P; p += kWarp) {
      const float px = sx[3 * p], py = sx[3 * p + 1], pz = sx[3 * p + 2];
      const float rel1 = py - hy;
      const float y = fminf(fmaxf(rel1, 0.0f), 2.0f * hook_half_len);
      const float dx = px - hx, dy = rel1 - y, dz = pz - hz;
      const float dist = sqrtf(dx * dx + dy * dy + dz * dz);
      const float phi = dist - hook_radius;
      if (phi < 0.0f) {
        const float nd = fmaxf(dist, 1e-9f);
        const float nx = dx / nd, ny = dy / nd, nz = dz / nd;
        const float pen = phi;  // min(phi, 0) with phi < 0
        const float ux = px - sprev[3 * p], uy = py - sprev[3 * p + 1], uz = pz - sprev[3 * p + 2];
        const float dn = ux * nx + uy * ny + uz * nz;
        const float tx = ux - dn * nx, ty = uy - dn * ny, tz = uz - dn * nz;
        const float tn = sqrtf(tx * tx + ty * ty + tz * tz);
        const float scale = fminf(1.0f, friction * (-pen) / fmaxf(tn, 1e-9f));
        sx[3 * p] = px + (-pen * nx - scale * tx);
        sx[3 * p + 1] = py + (-pen * ny - scale * ty);
        sx[3 * p + 2] = pz + (-pen * nz - scale * tz);
      }
    }
    __syncwarp();
  }

  float* ob = out + static_cast<size_t>(b) * PT * 3;
  for (int k = lane; k < 3 * PT; k += kWarp) ob[k] = sx[k];
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` and returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape the
// kernel does not take; the caller raises on anything but 0.
extern "C" int cloth_solve_env_launch(
    const float* x, const float* prev, const float* inv_mass, const float* hanger,
    const float* body_w, const int* att_particle, const int* group_i,
    const int* group_j, const float* group_rest, const float* group_mask,
    const int* group_offset, const float* group_compliance, const float* pair_mask,
    const float* active, float* out, int B, int P, int G, int n_groups,
    int c_total, int iterations, float dt, float hook_radius, float hook_half_len,
    float friction, float self_min_dist, void* stream) {
  if (B < 1 || n_groups < 0 || n_groups > kMaxGroups) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int PT = P + G;
  const bool self_on = self_min_dist > 0.0f;
  const size_t per_env = 7 * PT + c_total + (self_on ? 3 * PT : 0);
  const size_t bytes = sizeof(float) * (3 * static_cast<size_t>(c_total) + kEnvsPerCta * per_env);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cloth_solve_env_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = (B + kEnvsPerCta - 1) / kEnvsPerCta;
  cloth_solve_env_kernel<<<grid, kWarp * kEnvsPerCta, bytes, static_cast<cudaStream_t>(stream)>>>(
      x, prev, inv_mass, hanger, body_w, att_particle, group_i, group_j, group_rest,
      group_mask, group_offset, group_compliance, pair_mask, active, out, B, P, G, n_groups,
      c_total, iterations, dt, hook_radius, hook_half_len, friction, self_min_dist);
  return static_cast<int>(cudaGetLastError());
}
