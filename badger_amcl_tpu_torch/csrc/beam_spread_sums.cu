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
// runs in f32 in ascending g, the TPU kernel's order.
//
// Design: one thread per particle, particles in draw order. The TPU
// kernel's sigma sort, 1024-particle tiles, per-tile distinct-slab lists,
// doubled slab axis, one-hot MXU contraction and unsort exist so that a
// tile's reads become dense vector selects and matmuls; a thread here reads
// its particle's K-vector (512 contiguous bytes, L1-cached after the first
// touch) and wraps (sig + g) mod K itself. The occupied offsets sit in
// shared memory and n_g is read on the device, so launching needs no host
// sync. Phi (256 KiB) is read through the L2.
//
// Bound on the H100: bytes — the range-image rows of the particles (512 B
// each, 25.6 MB at 50k) against ~3 operations per (particle, offset).
// Neighbouring threads hold unrelated cells of a spread cloud, so the row
// reads do not coalesce across a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kOffsetChunk = 1024;

__global__ void beam_spread_sums_kernel(const uint16_t* __restrict__ rows, int k,
                                        const int64_t* __restrict__ flat,
                                        const int32_t* __restrict__ sig, int m,
                                        const int32_t* __restrict__ gocc,
                                        const int32_t* __restrict__ n_g,
                                        const float* __restrict__ phi, int v_size, int cap,
                                        float* __restrict__ out) {
  __shared__ int32_t s_g[kOffsetChunk];
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = p < m;
  const uint16_t* row = rows + (live ? flat[p] : 0) * (int64_t)k;
  const int s = live ? sig[p] : 0;
  const int n = *n_g;
  float acc = 0.0f;
  for (int base = 0; base < n; base += kOffsetChunk) {
    const int c = min(kOffsetChunk, n - base);
    __syncthreads();
    for (int i = threadIdx.x; i < c; i += blockDim.x) s_g[i] = gocc[base + i];
    __syncthreads();
    if (!live) continue;
    for (int i = 0; i < c; ++i) {
      const int g = s_g[i];
      int slab = s + g;
      if (slab >= k) slab -= k;
      const int v = min((int)row[slab], cap);
      acc = __fadd_rn(acc, phi[(int64_t)g * v_size + v]);
    }
  }
  if (live) out[p] = acc;
}

}  // namespace

extern "C" int beam_spread_sums_launch(const uint16_t* rows, int k, const int64_t* flat,
                                       const int32_t* sig, int m, const int32_t* gocc,
                                       const int32_t* n_g, const float* phi, int v_size,
                                       int cap, float* out, void* stream) {
  const int blocks = (m + kThreads - 1) / kThreads;
  beam_spread_sums_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, k, flat, sig, m, gocc, n_g, phi, v_size, cap, out);
  return (int)cudaGetLastError();
}
