// Per-particle point-cloud term sums for spread particle clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/pc_spread_kernel.py
// `_kernel3` (via `_tiered_call3` / `pc_spread_term_sums`): for every
// particle m
//
//   s[m] = sum_b t(z),  t(z) = pz^3 (likelihood_field) or pz (Gompertz),
//   pz   = z_hit * exp(-z^2 / denom) + zr,
//   z    = tex[k_b, cj, ci] * max_ratio, 255 * max_ratio off the map,
//          max_dist when the point's slab k_b is outside the z band,
//   ci   = floor(pxc + A_b ct - B_b st),  cj = floor(pyc + B_b ct + A_b st)
//
// with pxc = px * inv_res + (0.5 - min_i), ct/st the particle's cos/sin
// yaw and (A_b, B_b) = (qx_b, qy_b) * inv_res — the TPU kernel's endpoint
// formula (pc_spread_kernel.py:197-199, :445-446) and out-of-band constant
// (:595-597), over the z-major uint8 ratio texture (nz, ny, nx).
//
// Design: one thread per particle walks the points, whose (A, B, slab) sit
// in shared memory, staged in chunks. Output is in the ORIGINAL particle
// order: the TPU kernel's point and particle sorts, window tiers, escape
// arm and unsort exist to make its one-hot MXU gathers dense, and a direct
// gather needs none of them (so there is no escape capacity or point-slot
// budget to overflow). Every multiply and add is rounded separately, in
// the plain PyTorch version's order, and expf/cosf/sinf are the
// full-precision ones (no fast math). The terms are summed in double and
// rounded once, so the sum does not depend on a summation order to within
// f32 rounding.
//
// Bound on the H100: one expf and ~20 other f32 operations per (particle,
// point) — 12.8M pairs at 50k x 256 — against 3.4 MB of texture (L2
// resident) and an M x 4 B output: operations, not bytes. Neighbouring
// threads hold neighbouring particles of a spread cloud, so texture reads
// do not coalesce; they are L2 hits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointChunk = 1024;

__global__ void pc_spread_term_sums_kernel(
    const uint8_t* __restrict__ tex, int nx, int ny, int nz,
    const float* __restrict__ poses, int m, const float* __restrict__ points,
    int n_points, float inv_res, float off_x, float off_y, int min_k, float max_ratio,
    float max_dist, float z_hit, float denom, float zr, int cube, float* __restrict__ out) {
  __shared__ float s_a[kPointChunk];
  __shared__ float s_b[kPointChunk];
  __shared__ int s_kz[kPointChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < m;
  float pxc = 0.0f, pyc = 0.0f, c = 0.0f, s = 0.0f;
  if (live) {
    pxc = __fadd_rn(__fmul_rn(poses[3 * (int64_t)i], inv_res), off_x);
    pyc = __fadd_rn(__fmul_rn(poses[3 * (int64_t)i + 1], inv_res), off_y);
    const float th = poses[3 * (int64_t)i + 2];
    c = cosf(th);
    s = sinf(th);
  }
  double acc = 0.0;
  for (int base = 0; base < n_points; base += kPointChunk) {
    const int n = min(kPointChunk, n_points - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const float* q = points + 3 * (int64_t)(base + k);
      s_a[k] = __fmul_rn(q[0], inv_res);
      s_b[k] = __fmul_rn(q[1], inv_res);
      s_kz[k] = (int)floorf(__fadd_rn(__fmul_rn(q[2], inv_res), 0.5f)) - min_k;
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < n; ++k) {
      const int kz = s_kz[k];
      float z = max_dist;
      if (kz >= 0 && kz < nz) {
        const float a = s_a[k];
        const float b = s_b[k];
        const int ci = (int)floorf(__fsub_rn(__fadd_rn(pxc, __fmul_rn(a, c)), __fmul_rn(b, s)));
        const int cj = (int)floorf(__fadd_rn(__fadd_rn(pyc, __fmul_rn(b, c)), __fmul_rn(a, s)));
        float ratio = 255.0f;
        if (ci >= 0 && ci < nx && cj >= 0 && cj < ny) {
          ratio = (float)tex[((int64_t)kz * ny + cj) * nx + ci];
        }
        z = __fmul_rn(ratio, max_ratio);
      }
      const float e = expf(__fdiv_rn(-__fmul_rn(z, z), denom));
      const float pz = __fadd_rn(__fmul_rn(z_hit, e), zr);
      acc += (double)(cube ? __fmul_rn(__fmul_rn(pz, pz), pz) : pz);
    }
  }
  if (live) out[i] = (float)acc;
}

}  // namespace

extern "C" int pc_spread_term_sums_launch(const uint8_t* tex, int nx, int ny, int nz,
                                          const float* poses, int m, const float* points,
                                          int n_points, float inv_res, int min_i, int min_j,
                                          int min_k, float max_ratio, float max_dist,
                                          float z_hit, float denom, float zr, int cube,
                                          float* out, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  // (0.5 - min) is exact in f32 for any map a texture can hold
  pc_spread_term_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tex, nx, ny, nz, poses, m, points, n_points, inv_res, 0.5f - (float)min_i,
      0.5f - (float)min_j, min_k, max_ratio, max_dist, z_hit, denom, zr, cube, out);
  return (int)cudaGetLastError();
}
