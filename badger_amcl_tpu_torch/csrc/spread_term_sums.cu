// Per-particle likelihood-field term sums for spread particle clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/spread_kernel.py
// `_kernel` (via `_tiered_call` / `spread_term_sums`): for every particle m
//
//   s[m] = sum_{valid b} table[k],  k = q[cj, ci] + 128, or 256 off the map
//   ci   = floor(pxc + rca_b * ct - rsa_b * st),
//   cj   = floor(pyc + rsa_b * ct + rca_b * st)
//
// with q the int8 ratio-quantized distance texture (`quantized_tex`,
// :161-165, baked once on the map), pxc/pyc the particle in cell
// coordinates (+0.5 + half size), ct/st its cos/sin yaw and rca_b/rsa_b =
// r_b cos(a_b)/res, r_b sin(a_b)/res — the TPU kernel's own endpoint
// formula (:214-215). `table` holds the model's beam term t(pz(z)) (pz^3,
// pz or log pz: badger_amcl_tpu/sensors/planar.py:403-411, :472-475,
// :514-518) at z = q * max_d / 127 for the 256 int8 levels and at z =
// max_d off the map, evaluated by the wrapper with the plain version's own
// torch expression, so each term equals the plain version's bit for bit.
//
// Two entry points, launched in turn by the wrapper:
// - spread_prep_launch: one thread per particle computes pxc, pyc, ct and
//   st, one per beam rca and rsa, with the separately rounded operations of
//   the plain version's torch expression (IEEE division, full-precision
//   cosf/sinf), so both pick the same cells: one launch where the torch
//   expression took ~16;
// - spread_term_sums_launch: the sums.
//
// Bound on the H100: one dependent 1-byte texture read per (particle,
// beam), 36M at 50k x 720 from a 1 MB texture that stays in L2. The
// per-pair division, exp/log and cube of the earlier design became one
// lookup in the shared-memory term table. Design: a block of 32 particles
// x kGroups warps; warp g sums the beams b = g (mod kGroups) into a double
// and the warps' sums are added in group order and rounded once. Visiting
// the particles in the reference's yaw-primary snake order (an argsort of
// its key between the two launches) measured no faster for this kernel,
// whose reads are not what bounds it, and the sort cost more than it saved.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;
constexpr int kBeamChunk = 1024;
constexpr int kTable = 257;  // 256 int8 levels, then off the map
constexpr int kPrepThreads = 256;

__global__ void spread_prep_kernel(const float* __restrict__ spose, int m,
                                   const float* __restrict__ ranges,
                                   const float* __restrict__ angles, int n_beams,
                                   float origin_x, float origin_y, float res, float off_x,
                                   float off_y, float inv_res, float* __restrict__ pxc, float* __restrict__ pyc,
                                   float* __restrict__ ct, float* __restrict__ st,
                                   float* __restrict__ rca, float* __restrict__ rsa) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < m) {
    const float x = __fadd_rn(__fdiv_rn(__fsub_rn(spose[3 * i], origin_x), res), off_x);
    const float y = __fadd_rn(__fdiv_rn(__fsub_rn(spose[3 * i + 1], origin_y), res), off_y);
    const float yaw = spose[3 * i + 2];
    pxc[i] = x;
    pyc[i] = y;
    ct[i] = cosf(yaw);
    st[i] = sinf(yaw);
  }
  if (i < n_beams) {
    const float r = ranges[i];
    const float a = angles[i];
    rca[i] = __fmul_rn(__fmul_rn(r, cosf(a)), inv_res);
    rsa[i] = __fmul_rn(__fmul_rn(r, sinf(a)), inv_res);
  }
}

__global__ void __launch_bounds__(32 * kGroups) spread_term_sums_kernel(
    const int8_t* __restrict__ tex, int h, int w, const float* __restrict__ pxc,
    const float* __restrict__ pyc, const float* __restrict__ ct,
    const float* __restrict__ st, int m,
    const float* __restrict__ rca, const float* __restrict__ rsa,
    const bool* __restrict__ valid, int n_beams, const float* __restrict__ table,
    float* __restrict__ out) {
  __shared__ double s_table[kTable];
  __shared__ float s_rca[kBeamChunk];
  __shared__ float s_rsa[kBeamChunk];
  __shared__ bool s_valid[kBeamChunk];
  __shared__ double s_part[kGroups][32];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int g = threadIdx.y;
  for (int k = tid; k < kTable; k += 32 * kGroups) s_table[k] = (double)table[k];
  const int i = blockIdx.x * 32 + threadIdx.x;
  const bool live = i < m;
  const float px = live ? pxc[i] : 0.0f;
  const float py = live ? pyc[i] : 0.0f;
  const float c = live ? ct[i] : 0.0f;
  const float s = live ? st[i] : 0.0f;
  double acc = 0.0;
  for (int base = 0; base < n_beams; base += kBeamChunk) {
    const int n = min(kBeamChunk, n_beams - base);
    __syncthreads();
    for (int k = tid; k < n; k += 32 * kGroups) {
      s_rca[k] = rca[base + k];
      s_rsa[k] = rsa[base + k];
      s_valid[k] = valid[base + k];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = g; k < n; k += kGroups) {
      if (!s_valid[k]) continue;
      const float a = s_rca[k];
      const float b = s_rsa[k];
      const int ci = (int)floorf(__fsub_rn(__fadd_rn(px, __fmul_rn(a, c)), __fmul_rn(b, s)));
      const int cj = (int)floorf(__fadd_rn(__fadd_rn(py, __fmul_rn(b, c)), __fmul_rn(a, s)));
      int idx = kTable - 1;
      if (ci >= 0 && ci < w && cj >= 0 && cj < h) {
        idx = (int)__ldg(tex + (int64_t)cj * w + ci) + 128;
      }
      acc += s_table[idx];
    }
  }
  s_part[g][threadIdx.x] = acc;
  __syncthreads();
  if (g == 0 && live) {
    double sum = s_part[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) sum += s_part[j][threadIdx.x];
    out[i] = (float)sum;
  }
}

}  // namespace

extern "C" int spread_prep_launch(const float* spose, int m, const float* ranges,
                                  const float* angles, int n_beams, float origin_x,
                                  float origin_y, float res, float off_x, float off_y,
                                  float inv_res, float* pxc, float* pyc, float* ct, float* st,
                                  float* rca, float* rsa, void* stream) {
  const int n = m > n_beams ? m : n_beams;
  const int blocks = (n + kPrepThreads - 1) / kPrepThreads;
  spread_prep_kernel<<<blocks, kPrepThreads, 0, (cudaStream_t)stream>>>(
      spose, m, ranges, angles, n_beams, origin_x, origin_y, res, off_x, off_y, inv_res, pxc,
      pyc, ct, st, rca, rsa);
  return (int)cudaGetLastError();
}

extern "C" int spread_term_sums_launch(const int8_t* tex, int h, int w, const float* pxc,
                                       const float* pyc, const float* ct, const float* st,
                                       int m, const float* rca, const float* rsa,
                                       const bool* valid, int n_beams, const float* table,
                                       float* out, void* stream) {
  const int blocks = (m + 31) / 32;
  spread_term_sums_kernel<<<blocks, dim3(32, kGroups), 0, (cudaStream_t)stream>>>(
      tex, h, w, pxc, pyc, ct, st, m, rca, rsa, valid, n_beams, table, out);
  return (int)cudaGetLastError();
}
