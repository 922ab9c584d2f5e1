// Stencil-correlation table for the corr backend.
//
// Replaces the Pallas TPU kernels badger_amcl_tpu/ops/corr_kernel.py
// `_kernel_pre` (via `_corr_call_pre`) and `_kernel` (via `_corr_call`),
// which share the tap loop `_bin_loop`:
//
//   corr[t, dj, di] = sum_{b < nu[t]} w(t,b) * tex[oy + dj + oj(t,b), ox + di + oi(t,b)]
//
// for compacted yaw bins t < t_n, zero for t >= t_n. The taps are packed
// int32 `(w << 20) | (oj & 0x3FF) << 10 | (oi & 0x3FF)` (10-bit signed
// offsets, 12-bit dedup multiplicity; sentinel slots pack to 0) and are
// decoded exactly as `_bin_loop` does (corr_kernel.py:107-114).
//
// Design: one block per (t, dj), one thread per di (128 = PWIN_C). The
// block stages its bin's taps in shared memory and each thread walks them
// in tap order, accumulating `acc + w * v` with separately rounded multiply
// and add — the TPU kernel's own order and rounding, so the table agrees
// with it bit for bit. The texture is read directly from the padded psi
// texture: the TPU kernel's eight row-preshifted copies exist only for
// Mosaic's (8, 128)-aligned vector loads and are not built here. t_n, nu
// and the window origin are read on the device, so launching needs no
// host sync.
//
// Bound on the H100: texture reads. A block's 128 threads read one
// contiguous 512-byte row segment per tap, so a table costs about
// taps x rows x 512 B of L2 traffic (the 9.4 MB padded texture of a 1024^2
// map stays L2-resident): ~28 MB for the steady regime (2,259 taps x 24
// rows) and ~75 MB for tracking (4,550 x 32) at 50k x 720. Coalesced row
// reads keep that at L2 bandwidth; the taps come from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;       // PWIN_C
constexpr int kTapChunk = 1024;  // taps staged in shared memory per pass

__global__ void corr_table_kernel(const float* __restrict__ tex, int hp, int wp,
                                  const int32_t* __restrict__ off,
                                  const int32_t* __restrict__ nu,
                                  const int32_t* __restrict__ t_n,
                                  const int32_t* __restrict__ org,
                                  float* __restrict__ out, int n_beams, int rows) {
  __shared__ int32_t s_off[kTapChunk];
  const int t = blockIdx.x;
  const int dj = blockIdx.y;
  const int di = threadIdx.x;
  float acc = 0.0f;
  if (t < *t_n) {
    const int n_taps = nu[t];
    const int row = org[0] + dj;
    const int col = org[1] + di;
    const int32_t* taps = off + (int64_t)t * n_beams;
    for (int base = 0; base < n_taps; base += kTapChunk) {
      const int n = min(kTapChunk, n_taps - base);
      __syncthreads();
      for (int k = threadIdx.x; k < n; k += blockDim.x) s_off[k] = taps[base + k];
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const int32_t packed = s_off[k];
        const float w = (float)((uint32_t)packed >> 20);
        const int oj = ((int32_t)((uint32_t)packed << 12)) >> 22;
        const int oi = ((int32_t)((uint32_t)packed << 22)) >> 22;
        // offsets are bounded by the prepass's range envelope; the clamp
        // only guards memory on inputs outside it
        const int r = min(max(row + oj, 0), hp - 1);
        const int c = min(max(col + oi, 0), wp - 1);
        acc = __fadd_rn(acc, __fmul_rn(w, tex[(int64_t)r * wp + c]));
      }
    }
  }
  out[((int64_t)t * rows + dj) * kCols + di] = acc;
}

}  // namespace

extern "C" int corr_table_launch(const float* tex, int hp, int wp, const int32_t* off,
                                 const int32_t* nu, const int32_t* t_n,
                                 const int32_t* org, float* out, int t_max,
                                 int n_beams, int rows, void* stream) {
  dim3 grid(t_max, rows);
  corr_table_kernel<<<grid, kCols, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nu, t_n, org, out, n_beams, rows);
  return (int)cudaGetLastError();
}
