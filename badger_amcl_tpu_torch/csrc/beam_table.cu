// Lattice beam-model table for tracking clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/beam_kernel.py
// `_kernel` (via `_beam_call`): for compacted yaw bins t < max(t_n, 1)
//
//   corr[t, dj, di] = sum_b Phi[b, min(R[k(t,b), j0 + dj, i0 + di], cap)],
//   k(t, b) = round_half_even(((t_min + t_order[t]) * dtheta + a_b) * bin_inv) mod K,
//   Phi[b, v] = pz^3 at m = min(v * res, range_max),
//   pz = z_hit exp(-(o - m)^2 * denom_inv) + (o - m < 0 ? z_short lam exp(-lam o) : 0)
//        + (o == range_max ? z_max : 0) + (o < range_max ? z_rand_mult : 0)
//
// with o = obs[b] and R the uint16 (K, H, W) range image in cells; slots
// t >= max(t_n, 1) are zero. cap is the smallest v with f32(v) * res >=
// range_max (65535 if none), so Phi[b, min(v, cap)] is the mixture at v
// for every uint16 v. The arithmetic is the TPU kernel's
// (beam_kernel.py:89-108): bin_inv = f32(K) / f32(2 pi), a multiply by
// denom_inv (never a division), every multiply and add rounded separately,
// beams summed in ascending order, full-precision expf (no fast math). A k
// off by one would move the beam by a whole angular slab.
//
// Two launches per table (beam_table_launch):
// - beam_prep_kernel: the value table Phi (B rows of ld = cap + 1 rounded
//   up to 4 floats), one thread per (beam, v), with the mixture's
//   per-element arithmetic, and the slab table k(t, b) (B, t_max) uint16;
//   the mixture depends on the beam and on v only, so the table holds it
//   for every (bin, cell) that reads it;
// - beam_table_kernel: one warp per window cell, lane t per compacted yaw
//   bin (t and t + 32 when t_n > 32), kWarps cells per block, about one
//   block per SM at the 24-row window. The block stages its cells'
//   K-vectors R[:, j, i] (the window transposed to cell-major) and,
//   kStageBeams beams at a time, double-buffered with async copies, the
//   beams' table and slab rows in shared memory. Per (bin, beam, cell) a
//   lane reads its slab index, the cell's range at that slab and the
//   beam's table entry (a beam's 32 lanes read neighbouring slabs of one
//   vector and nearby entries of one table row) and adds. A table row too
//   large to stage (cap up to 65535) takes the kernel's device-memory arm,
//   which reads the table and slab rows from device memory.
// The TPU kernel compacts R to a (K, rows, 128) VMEM window with an XLA
// dynamic_slice on every call; here each block reads its cells' vectors
// from the full image. t_n, t_min and the window origin are read on the
// device, so launching needs no host sync.
//
// Bound on the H100: 2 operations per (slot, beam, cell) (the min and the
// add; 44M-64M cells x beams in the beam cells) plus the value table, 16
// operations per (beam, v). A thread per window column (the table read
// through L1, or staged per block) measured slower: a warp's 32 columns
// read 32 scattered entries of a table row.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The mixture's constants (ops.beam_kernel.BeamMix, each an f32), the yaw
// bin width and bin_inv, in the field order of _build.BeamConsts; the
// wrapper passes one cached host copy, which keeps the launch call short
// (the beam cells are host-bound).
struct BeamConsts {
  float z_hit, z_short, z_max, z_rand_mult, range_max, denom_inv, lam, res, dtheta, bin_inv;
};

namespace {

constexpr int kCols = 128;        // PWIN_C
constexpr int kWarps = 24;        // window cells per block
constexpr int kStageBeams = 32;   // beams per staged chunk
constexpr int kMaxBins = 64;      // T_MAX: two bins per lane
constexpr int kStageLimit = 200 * 1024;
constexpr int kPrepThreads = 256;

// threads [0, B * n_v): the value table; then [.., + B * t_max): the slabs
__global__ void beam_prep_kernel(const float* __restrict__ obs, int n_beams, int n_v, int ld,
                                 BeamConsts c, float* __restrict__ table,
                                 const float* __restrict__ angles,
                                 const int32_t* __restrict__ t_min,
                                 const int32_t* __restrict__ t_order, int t_max, int k_angles,
                                 uint16_t* __restrict__ slabs) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < (int64_t)n_beams * n_v) {
    const int b = (int)(i / n_v);
    const int v = (int)(i - (int64_t)b * n_v);
    const float o = obs[b];
    const float s_short = __fmul_rn(__fmul_rn(c.z_short, c.lam), expf(__fmul_rn(-c.lam, o)));
    const float s_max = o == c.range_max ? c.z_max : 0.0f;
    const float s_rand = o < c.range_max ? c.z_rand_mult : 0.0f;
    const float m = fminf(__fmul_rn((float)v, c.res), c.range_max);
    const float z = __fsub_rn(o, m);
    float pz = __fmul_rn(c.z_hit, expf(__fmul_rn(-__fmul_rn(z, z), c.denom_inv)));
    pz = __fadd_rn(pz, z < 0.0f ? s_short : 0.0f);
    pz = __fadd_rn(pz, s_max);
    pz = __fadd_rn(pz, s_rand);
    table[(int64_t)b * ld + v] = __fmul_rn(__fmul_rn(pz, pz), pz);
    return;
  }
  i -= (int64_t)n_beams * n_v;
  if (i < (int64_t)n_beams * t_max) {
    const int b = (int)(i / t_max);
    const int t = (int)(i - (int64_t)b * t_max);
    const float t_raw = __fmul_rn((float)(*t_min + t_order[t]), c.dtheta);
    const int k = __float2int_rn(__fmul_rn(__fadd_rn(t_raw, angles[b]), c.bin_inv));
    slabs[i] = (uint16_t)(((k % k_angles) + k_angles) % k_angles);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(32 * kWarps) beam_table_kernel(
    const uint16_t* __restrict__ rimg, int k_angles, int h, int w, int n_beams,
    const int32_t* __restrict__ t_n, const uint16_t* __restrict__ slabs,
    const int32_t* __restrict__ org, const float* __restrict__ table, int cap, int ld,
    float* __restrict__ out, int t_max, int rows, int vec_bytes) {
  // [kWarps x K uint16 vectors][2 x kStageBeams x ld table][2 x kStageBeams x t_max slabs]
  extern __shared__ float4 s_dyn[];
  uint16_t* s_vec = reinterpret_cast<uint16_t*>(s_dyn);
  float* s_tab = reinterpret_cast<float*>(reinterpret_cast<char*>(s_dyn) + vec_bytes);
  uint16_t* s_slab = reinterpret_cast<uint16_t*>(s_tab + 2 * kStageBeams * ld);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_cells = rows * kCols;
  const int cell = blockIdx.x * kWarps + warp;
  const int64_t plane = (int64_t)h * w;
  for (int i = threadIdx.x; i < k_angles * kWarps; i += blockDim.x) {
    const int k = i / kWarps;
    const int c = i - k * kWarps;
    const int cc = blockIdx.x * kWarps + c;
    if (cc < n_cells) {
      s_vec[c * k_angles + k] = __ldg(rimg + k * plane + (int64_t)(org[0] + cc / kCols) * w
                                      + org[1] + cc % kCols);
    }
  }
  const uint16_t* vec = s_vec + warp * k_angles;
  const int nt = max(*t_n, 1);
  const bool two = nt > 32;
  const int n_chunks = (n_beams + kStageBeams - 1) / kStageBeams;
  // a chunk's table rows (ld a multiple of 4 floats) and slab rows (t_max a
  // multiple of 8) into buffer c & 1
  auto stage = [&](int c) {
    const int n = min(kStageBeams, n_beams - c * kStageBeams);
    const float4* tsrc = reinterpret_cast<const float4*>(table + (int64_t)c * kStageBeams * ld);
    float4* tdst = reinterpret_cast<float4*>(s_tab) + (c & 1) * (kStageBeams * ld / 4);
    for (int i = threadIdx.x; i < n * ld / 4; i += blockDim.x) {
      __pipeline_memcpy_async(tdst + i, tsrc + i, sizeof(float4));
    }
    const float4* ssrc =
        reinterpret_cast<const float4*>(slabs + (int64_t)c * kStageBeams * t_max);
    float4* sdst = reinterpret_cast<float4*>(s_slab) + (c & 1) * (kStageBeams * t_max / 8);
    for (int i = threadIdx.x; i < n * t_max / 8; i += blockDim.x) {
      __pipeline_memcpy_async(sdst + i, ssrc + i, sizeof(float4));
    }
  };
  if (kStaged) {
    stage(0);
    __pipeline_commit();
  }
  __syncthreads();
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kStageBeams;
    const int n = min(kStageBeams, n_beams - base);
    if (kStaged) {
      if (c + 1 < n_chunks) stage(c + 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();
    }
    const float* tab = kStaged ? s_tab + (c & 1) * kStageBeams * ld : table + (int64_t)base * ld;
    const uint16_t* sl =
        kStaged ? s_slab + (c & 1) * kStageBeams * t_max : slabs + (int64_t)base * t_max;
    if (cell < n_cells) {
#pragma unroll 8
      for (int b = 0; b < n; ++b) {
        const float* phi = tab + (int64_t)b * ld;
        const uint16_t* sb = sl + b * t_max;
        acc0 = __fadd_rn(acc0, phi[min((int)vec[sb[lane]], cap)]);
        if (two) acc1 = __fadd_rn(acc1, phi[min((int)vec[sb[32 + lane]], cap)]);
      }
    }
    if (kStaged) __syncthreads();
  }
  // out is (t_max, rows, 128): bin t's table starts at t * n_cells
  if (cell < n_cells) {
    out[(int64_t)lane * n_cells + cell] = lane < nt ? acc0 : 0.0f;
    const int t1 = 32 + lane;
    if (t1 < t_max) out[(int64_t)t1 * n_cells + cell] = t1 < nt ? acc1 : 0.0f;
  }
}

void launch_prep(const float* obs, int n_beams, int n_v, int ld, const BeamConsts& c,
                 float* table, const float* angles, const int32_t* t_min,
                 const int32_t* t_order, int t_max, int k_angles, uint16_t* slabs,
                 cudaStream_t stream) {
  const int64_t n = (int64_t)n_beams * (n_v + t_max);
  beam_prep_kernel<<<(unsigned)((n + kPrepThreads - 1) / kPrepThreads), kPrepThreads, 0,
                     stream>>>(obs, n_beams, n_v, ld, c, table, angles, t_min, t_order, t_max,
                               k_angles, slabs);
}

template <bool kStaged>
void launch_table(const uint16_t* rimg, int k_angles, int h, int w, int n_beams,
                  const int32_t* t_n, const uint16_t* slabs, const int32_t* org,
                  const float* table, int cap, int ld, float* out, int t_max, int rows,
                  int vec_bytes, int smem, cudaStream_t stream) {
  static int granted = 48 * 1024;  // dynamic shared memory the kernel may take
  if (smem > granted) {
    cudaFuncSetAttribute(beam_table_kernel<kStaged>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem);
    granted = smem;
  }
  const int blocks = (rows * kCols + kWarps - 1) / kWarps;
  beam_table_kernel<kStaged><<<blocks, 32 * kWarps, smem, stream>>>(
      rimg, k_angles, h, w, n_beams, t_n, slabs, org, table, cap, ld, out, t_max, rows,
      vec_bytes);
}

}  // namespace

// The lattice table (t_max, rows, 128) at `out`. `scratch` takes the value
// table (B x ld floats, ld = cap + 1 rounded up to a multiple of 4), then
// the slab table (B x t_max uint16); it must be 16-byte aligned.
extern "C" int beam_table_launch(const uint16_t* rimg, int k_angles, int h, int w,
                                 const float* obs, const float* angles, int n_beams,
                                 const int32_t* t_n, const int32_t* t_min,
                                 const int32_t* t_order, const int32_t* org,
                                 const BeamConsts* consts, float* scratch, int cap,
                                 float* out, int t_max, int rows, void* stream) {
  if (t_max > kMaxBins || t_max % 8 != 0 || n_beams <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int ld = (cap + 4) & ~3;
  uint16_t* slabs = reinterpret_cast<uint16_t*>(scratch + (int64_t)n_beams * ld);
  launch_prep(obs, n_beams, cap + 1, ld, *consts, scratch, angles, t_min, t_order, t_max,
              k_angles, slabs, s);
  const int vec_bytes = (kWarps * k_angles * (int)sizeof(uint16_t) + 15) & ~15;
  const int64_t stage_bytes = (int64_t)2 * kStageBeams * (ld * 4 + t_max * 2);
  if (vec_bytes + stage_bytes <= kStageLimit) {
    launch_table<true>(rimg, k_angles, h, w, n_beams, t_n, slabs, org, scratch, cap, ld, out,
                       t_max, rows, vec_bytes, vec_bytes + (int)stage_bytes, s);
  } else {
    launch_table<false>(rimg, k_angles, h, w, n_beams, t_n, slabs, org, scratch, cap, ld, out,
                        t_max, rows, vec_bytes, vec_bytes, s);
  }
  return (int)cudaGetLastError();
}
