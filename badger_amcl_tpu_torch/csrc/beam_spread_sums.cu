// Beam-model sums for spread particle clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/beam_spread_kernel.py
// `_kernel` (via `_call` / `beam_spread_values`): for every particle p
//
//   s[p] = sum_{i < n_g} Phi[g_i, min(R_rows[flat_p, (sig_p + g_i) mod K], cap)]
//
// over the occupied slab offsets g_i (ascending, compacted to the front of
// `gocc`), with R_rows the transposed uint16 range image (H * W, K) in
// cells, flat_p the particle's (clipped) cell, sig_p its slab and Phi the
// (K, V) f32 per-offset mixture tables built outside the kernel. The sum
// runs in f32 in ascending g, the TPU kernel's order, so the kernel is
// bit-equal to the plain version.
//
// Output is in draw order: the TPU kernel's sigma sort, 1024-particle
// tiles, per-tile distinct-slab lists, doubled slab axis, one-hot MXU
// contraction and unsort exist so that a tile's reads become dense vector
// selects and matmuls. n_g is read on the device, so launching needs no
// host sync.
//
// Bound on the H100: bytes, the range-image rows of the distinct cells
// the particles occupy (512 B each at K = 256; 14,351 cells of a 50k
// spread cloud) against ~3 operations per (particle, offset). One thread
// walking its particle's offsets in turn, as a first design did, issues
// 193 dependent pairs of scattered loads (a 2-byte texel of its own row,
// then Phi), a latency chain at ~12 warps per SM. Design:
//   - a warp owns 32 particles and first stages their rows in shared
//     memory: per particle one coalesced 16-byte load per lane (512 B per
//     warp load at K = 256), eight rows' loads issued before their
//     stores. Each value is stored as min(v, cap), one byte (cap < 256),
//     at its place in the row rotated by the particle's slab, so the
//     offset g reads byte g of the row: no mod K in the sum, and the 32
//     lanes, which read column g of 32 rows of an odd word stride, hit
//     32 banks;
//   - then each lane sums its particle: per offset a broadcast read of
//     g, the row byte, the Phi value (L1) and the add, in ascending g;
//     the loop is unrolled by 16, so the loads of 16 offsets are in
//     flight ahead of the in-order adds.
// Timed against 2 and 8 warps per block, 4 rows loaded ahead, 16 rows
// ahead and unrolls of 8 and 32: 4 warps, 8 rows and 16 offsets ahead
// were best or within the spread.
// Shared memory: K int32 offsets plus 32 rows of about K bytes per warp
// (34 KB for 4 warps at K = 256); a block takes fewer warps where a large
// K needs it, and K up to ~6,400 fits one warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;      // warps per block, 32 particles each
constexpr int kRowsAhead = 8;  // rows loaded before their stores
constexpr int kMaxSmem = 232448;

// the byte stride of a staged row: K rounded up to a word, an odd number
// of words
__host__ __device__ inline int row_stride(int k) {
  const int words = (k + 3) / 4;
  return 4 * (words | 1);
}

__host__ inline size_t smem_bytes(int k, int warps) {
  return 4 * (size_t)k + (size_t)warps * 32 * row_stride(k);
}

__global__ void __launch_bounds__(32 * kWarps) beam_spread_sums_kernel(
    const uint16_t* __restrict__ rows, int k, const int64_t* __restrict__ flat,
    const int32_t* __restrict__ sig, int m, const int32_t* __restrict__ gocc,
    const int32_t* __restrict__ n_g, const float* __restrict__ phi, int v_size, int cap,
    float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s_g = (int32_t*)smem;
  const int stride = row_stride(k);
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint8_t* s_rows = smem + 4 * (size_t)k + (size_t)warp * 32 * stride;
  const int n = *n_g;
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_g[i] = gocc[i];

  const int p0 = (blockIdx.x * warps + warp) * 32;
  const int p = p0 + lane;
  const bool live = p < m;
  const int64_t my_flat = live ? flat[p] : 0;
  const int my_sig = live ? sig[p] : 0;
  const int n_rows = max(0, min(32, m - p0));
  const bool vec = k % 8 == 0;  // rows start 16-byte aligned
  for (int e0 = lane * 8; e0 - lane * 8 < k; e0 += 256) {
    for (int j0 = 0; j0 < n_rows; j0 += kRowsAhead) {
      uint4 q[kRowsAhead];  // 8 values of each of kRowsAhead rows
      int sg[kRowsAhead];
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        const int j = min(j0 + u, n_rows - 1);
        const int64_t f = __shfl_sync(0xffffffffu, my_flat, j);
        sg[u] = __shfl_sync(0xffffffffu, my_sig, j);
        const uint16_t* row = rows + f * k;
        if (vec && e0 < k) {
          q[u] = __ldg((const uint4*)(row + e0));
        } else {
          uint32_t w[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t lo = e0 + 2 * e < k ? __ldg(row + e0 + 2 * e) : 0u;
            const uint32_t hi = e0 + 2 * e + 1 < k ? __ldg(row + e0 + 2 * e + 1) : 0u;
            w[e] = lo | (hi << 16);
          }
          q[u] = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsAhead; ++u) {
        if (j0 + u >= n_rows) break;
        uint8_t* dst = s_rows + (j0 + u) * stride;
        const uint32_t w[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e0 + e >= k) break;
          int d = e0 + e - sg[u];
          if (d < 0) d += k;
          const int v = (int)((w[e / 2] >> (16 * (e % 2))) & 0xffffu);
          dst[d] = (uint8_t)min(v, cap);
        }
      }
    }
  }
  __syncthreads();
  if (!live) return;
  const uint8_t* mine = s_rows + lane * stride;
  float acc = 0.0f;
#pragma unroll 16
  for (int i = 0; i < n; ++i) {
    const int g = s_g[i];
    acc = __fadd_rn(acc, __ldg(phi + g * v_size + mine[g]));
  }
  out[p] = acc;
}

}  // namespace

extern "C" int beam_spread_sums_launch(const uint16_t* rows, int k, const int64_t* flat,
                                       const int32_t* sig, int m, const int32_t* gocc,
                                       const int32_t* n_g, const float* phi, int v_size,
                                       int cap, float* out, void* stream) {
  int warps = kWarps;
  while (warps > 1 && smem_bytes(k, warps) > kMaxSmem) warps /= 2;
  const size_t smem = smem_bytes(k, warps);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        beam_spread_sums_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int per_block = 32 * warps;
  beam_spread_sums_kernel<<<(m + per_block - 1) / per_block, per_block, smem,
                            (cudaStream_t)stream>>>(rows, k, flat, sig, m, gocc, n_g, phi,
                                                    v_size, cap, out);
  return (int)cudaGetLastError();
}
