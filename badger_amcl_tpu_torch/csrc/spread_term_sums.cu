// Per-particle likelihood-field term sums for spread particle clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/spread_kernel.py
// `_kernel` (via `_tiered_call` / `spread_term_sums`): for every particle m
//
//   s[m] = sum_{valid b} t(pz),  pz = z_hit * exp(-z^2 / denom) + zr,
//   t    = pz^3 (form 0, likelihood_field), pz (form 1, Gompertz) or
//          logf(pz) (form 2, prob) — the models' terms
//          (badger_amcl_tpu/sensors/planar.py:403-411,
//          :472-475, :514-518),
//   z    = q[cj, ci] * max_d / 127   (int8 ratio-quantized distance),
//          max_d when (ci, cj) is off the map,
//   ci   = floor(pxc + rca_b * ct - rsa_b * st),
//   cj   = floor(pyc + rsa_b * ct + rca_b * st)
//
// with pxc/pyc the particle in cell coordinates (+0.5 + half size),
// ct/st its cos/sin yaw and rca_b/rsa_b = r_b cos(a_b)/res, r_b sin(a_b)/res
// — the TPU kernel's own endpoint formula (spread_kernel.py:214-215) and
// texture (`quantized_tex`, :161-165).
//
// Design: one thread per particle walks the beams; the per-beam constants
// sit in shared memory, staged in chunks. Output is in the ORIGINAL
// particle order: the TPU kernel's yaw/block sort, window tiers, escape
// arm and unsort exist to make its one-hot MXU gathers dense, and a direct
// gather needs none of them (so there is no escape capacity to overflow).
// Every multiply and add of a term is rounded separately, in the order of
// the plain PyTorch version, and expf and logf are the full-precision ones
// (no fast math), so kernel and plain version pick the same cells and
// terms. The terms are summed in double and rounded once: an f32 running
// sum over 720 beams drifts by up to hundreds of ulp from any other
// summation order.
//
// Bound on the H100: one dependent 1-byte texture read per (particle,
// beam) — 36M scattered reads at 50k x 720, served from L2 (a 1024^2
// int8 texture is 1 MB) — plus one expf each. Neighbouring threads hold
// neighbouring particles of a spread cloud, so reads do not coalesce; the
// tiny texture keeps every read an L2 hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBeamChunk = 1024;

__global__ void spread_term_sums_kernel(
    const int8_t* __restrict__ tex, int h, int w, const float* __restrict__ pxc,
    const float* __restrict__ pyc, const float* __restrict__ ct,
    const float* __restrict__ st, int m, const float* __restrict__ rca,
    const float* __restrict__ rsa, const uint8_t* __restrict__ valid, int n_beams,
    float scale, float max_d, float z_hit, float denom, float zr, int form,
    float* __restrict__ out) {
  __shared__ float s_rca[kBeamChunk];
  __shared__ float s_rsa[kBeamChunk];
  __shared__ uint8_t s_valid[kBeamChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < m;
  const float px = live ? pxc[i] : 0.0f;
  const float py = live ? pyc[i] : 0.0f;
  const float c = live ? ct[i] : 0.0f;
  const float s = live ? st[i] : 0.0f;
  double acc = 0.0;
  for (int base = 0; base < n_beams; base += kBeamChunk) {
    const int n = min(kBeamChunk, n_beams - base);
    __syncthreads();
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      s_rca[k] = rca[base + k];
      s_rsa[k] = rsa[base + k];
      s_valid[k] = valid[base + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < n; ++k) {
      if (!s_valid[k]) continue;
      const float a = s_rca[k];
      const float b = s_rsa[k];
      const int ci = (int)floorf(__fsub_rn(__fadd_rn(px, __fmul_rn(a, c)), __fmul_rn(b, s)));
      const int cj = (int)floorf(__fadd_rn(__fadd_rn(py, __fmul_rn(b, c)), __fmul_rn(a, s)));
      float z = max_d;
      if (ci >= 0 && ci < w && cj >= 0 && cj < h) {
        z = __fmul_rn((float)tex[(int64_t)cj * w + ci], scale);
      }
      const float e = expf(__fdiv_rn(-__fmul_rn(z, z), denom));
      const float pz = __fadd_rn(__fmul_rn(z_hit, e), zr);
      const float t = form == 0 ? __fmul_rn(__fmul_rn(pz, pz), pz) : form == 1 ? pz : logf(pz);
      acc += (double)t;
    }
  }
  if (live) out[i] = (float)acc;
}

}  // namespace

extern "C" int spread_term_sums_launch(const int8_t* tex, int h, int w, const float* pxc,
                                       const float* pyc, const float* ct, const float* st,
                                       int m, const float* rca, const float* rsa,
                                       const uint8_t* valid, int n_beams, float scale,
                                       float max_d, float z_hit, float denom, float zr,
                                       int form, float* out, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  spread_term_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      tex, h, w, pxc, pyc, ct, st, m, rca, rsa, valid, n_beams, scale, max_d, z_hit,
      denom, zr, form, out);
  return (int)cudaGetLastError();
}
