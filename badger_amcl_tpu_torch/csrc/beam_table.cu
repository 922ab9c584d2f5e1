// Lattice beam-model table for tracking clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/beam_kernel.py
// `_kernel` (via `_beam_call`): for compacted yaw bins t < max(t_n, 1)
//
//   corr[t, dj, di] = sum_b phi_b(min(R[k(t,b), j0 + dj, i0 + di] * res, range_max)),
//   k(t, b) = round_half_even(((t_min + t_order[t]) * dtheta + a_b) * bin_inv) mod K,
//   phi_b(m) = pz^3,  pz = z_hit exp(-(o - m)^2 * denom_inv)
//                        + (o - m < 0 ? z_short lam exp(-lam o) : 0)
//                        + (o == range_max ? z_max : 0) + (o < range_max ? z_rand_mult : 0)
//
// with o = obs[b] and R the uint16 (K, H, W) range image in cells; slots
// t >= max(t_n, 1) are zero. The arithmetic is the TPU kernel's
// (beam_kernel.py:89-108): bin_inv = f32(K) / f32(2 pi), a multiply by
// denom_inv (never a division), every multiply and add rounded separately,
// beams summed in ascending order, full-precision expf (no fast math). A k
// off by one would move the beam by a whole angular slab.
//
// Design: one block per (compacted yaw bin, window row), one thread per
// window column (128) with the beam loop inside — corr_table.cu's shape.
// The block stages each beam's slab index k(t, b), its observed range, its
// short-reading term (which depends on o alone) and its max/rand constants
// in shared memory. The TPU kernel compacts R to a (K, rows, 128) VMEM
// window with an XLA dynamic_slice on every call; here each thread reads
// R[k, j0 + row, i0 + col] directly from the full image. t_n, t_min and
// the window origin are read on the device, so launching needs no host
// sync.
//
// Bound on the H100: the mixture, ~20 f32 operations and one expf per
// (slot, beam, cell) — 44M elements for a 24-row table of 20 bins at 720
// beams. The window's bytes (K x rows x 128 x 2 B, 1.5-4 MiB) stay
// L2-resident; a warp's 32 columns read 64 contiguous bytes of one slab row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;        // PWIN_C
constexpr int kBeamChunk = 1024;  // beams staged in shared memory per pass

__global__ void beam_table_kernel(const uint16_t* __restrict__ rimg, int k_angles, int h,
                                  int w, const float* __restrict__ obs,
                                  const float* __restrict__ angles, int n_beams,
                                  const int32_t* __restrict__ meta,
                                  const int32_t* __restrict__ t_order,
                                  const int32_t* __restrict__ org, float z_hit,
                                  float z_short, float z_max, float z_rand_mult,
                                  float range_max, float denom_inv, float lam, float res,
                                  float dtheta, float bin_inv, float* __restrict__ out,
                                  int rows) {
  __shared__ int32_t s_k[kBeamChunk];
  __shared__ float s_obs[kBeamChunk];
  __shared__ float s_short[kBeamChunk];
  __shared__ float s_max[kBeamChunk];
  __shared__ float s_rand[kBeamChunk];
  const int t = blockIdx.x;
  const int row = blockIdx.y;
  const int col = threadIdx.x;
  float acc = 0.0f;
  if (t < max(meta[0], 1)) {
    const float t_raw = __fmul_rn((float)(meta[1] + t_order[t]), dtheta);
    const int64_t plane = (int64_t)h * w;
    const int64_t cell = (int64_t)(org[0] + row) * w + (org[1] + col);
    for (int base = 0; base < n_beams; base += kBeamChunk) {
      const int n = min(kBeamChunk, n_beams - base);
      __syncthreads();
      for (int b = threadIdx.x; b < n; b += blockDim.x) {
        const float theta = __fadd_rn(t_raw, angles[base + b]);
        int k = __float2int_rn(__fmul_rn(theta, bin_inv));
        k = ((k % k_angles) + k_angles) % k_angles;
        const float o = obs[base + b];
        s_k[b] = k;
        s_obs[b] = o;
        s_short[b] = __fmul_rn(__fmul_rn(z_short, lam), expf(__fmul_rn(-lam, o)));
        s_max[b] = o == range_max ? z_max : 0.0f;
        s_rand[b] = o < range_max ? z_rand_mult : 0.0f;
      }
      __syncthreads();
      for (int b = 0; b < n; ++b) {
        const float v = (float)rimg[s_k[b] * plane + cell];
        const float m = fminf(__fmul_rn(v, res), range_max);
        const float z = __fsub_rn(s_obs[b], m);
        float pz = __fmul_rn(z_hit, expf(__fmul_rn(-__fmul_rn(z, z), denom_inv)));
        pz = __fadd_rn(pz, z < 0.0f ? s_short[b] : 0.0f);
        pz = __fadd_rn(pz, s_max[b]);
        pz = __fadd_rn(pz, s_rand[b]);
        acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(pz, pz), pz));
      }
    }
  }
  out[((int64_t)t * rows + row) * kCols + col] = acc;
}

}  // namespace

extern "C" int beam_table_launch(const uint16_t* rimg, int k_angles, int h, int w,
                                 const float* obs, const float* angles, int n_beams,
                                 const int32_t* meta, const int32_t* t_order,
                                 const int32_t* org, float z_hit, float z_short, float z_max,
                                 float z_rand_mult, float range_max, float denom_inv,
                                 float lam, float res, float dtheta, float bin_inv,
                                 float* out, int t_max, int rows, void* stream) {
  dim3 grid(t_max, rows);
  beam_table_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
      rimg, k_angles, h, w, obs, angles, n_beams, meta, t_order, org, z_hit, z_short, z_max,
      z_rand_mult, range_max, denom_inv, lam, res, dtheta, bin_inv, out, rows);
  return (int)cudaGetLastError();
}
