// Stencil-correlation tables for the corr backends: one tap loop, three
// entry points.
//
// Replaces the Pallas TPU kernels of badger_amcl_tpu/ops/corr_kernel.py:
// - corr_table_launch: `_kernel_pre` (via `_corr_call_pre`) and `_kernel`
//   (via `_corr_call`), which share the tap loop `_bin_loop`;
// - fleet_corr_table_launch: `_kernel_fleet` (via `fleet_corr_call`), the
//   same table for R robots in one call;
// - corr_table_q_launch: `_kernel_q` (via `_corr_call_q`), the table over
//   the int8 ratio-quantized texture with int32 sums.
//
//   corr[r, t, dj, di] = sum_{b < nu} w(t,b) * tex[oy_r + dj + oj(t,b), ox_r + di + oi(t,b)]
//
// for compacted yaw bins t < t_n[r], zero for t >= t_n[r]. The taps are
// packed int32 `(w << 20) | (oj & 0x3FF) << 10 | (oi & 0x3FF)` (10-bit
// signed offsets, 12-bit dedup multiplicity; sentinel slots pack to 0) and
// are decoded exactly as `_bin_loop` does (corr_kernel.py:107-114). The
// single-robot tables read nu per bin; the fleet's undeduplicated unit
// taps give every bin of robot r nv[r] taps, and nv = 0 runs no tap (the
// TPU fleet kernel runs max(nv, 1) and so adds tap slot 0 for a robot
// without a valid beam; the single-robot kernels run none).
//
// Design: one block per (t, dj, robot), one thread per di (128 = PWIN_C).
// The block stages its bin's taps in shared memory and each thread walks
// them in tap order. f32: `acc + w * v` with separately rounded multiply
// and add, the TPU kernel's own order and rounding, so the table agrees
// with it bit for bit. int8: `acc + w * q` in int32, exact in any order.
// Each robot reads the shared padded texture at its own window origin: the
// TPU kernels' row-preshifted copies (eight f32, four int8), per-robot
// (512, 1024) slices, 8-row blocking and row rolls exist only for Mosaic's
// aligned vector loads and are not built here. t_n, the tap counts and the
// origins are read on the device, so launching needs no host sync.
//
// Bound on the H100: texture reads. A block's 128 threads read one
// contiguous row segment (512 B in f32, 128 B in int8) per tap, so a table
// costs about taps x rows x 512 B of L2 traffic (the 9.4 MB padded f32 and
// 2.4 MB int8 textures of a 1024^2 map stay L2-resident): ~75 MB for the
// single-robot tracking regime (4,550 taps x 32 rows) at 50k x 720, and
// per robot ~18 bins x 180 taps x 32 rows x 512 B = 53 MB for the fleet's
// tracking robots. Coalesced row reads keep that at L2 bandwidth; the
// taps come from shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;       // PWIN_C
constexpr int kTapChunk = 1024;  // taps staged in shared memory per pass

__device__ __forceinline__ float tap_add(float acc, uint32_t w, float v) {
  return __fadd_rn(acc, __fmul_rn((float)w, v));
}

__device__ __forceinline__ int32_t tap_add(int32_t acc, uint32_t w, int8_t v) {
  return acc + (int32_t)w * (int32_t)v;
}

// nu index of (robot r, bin t) = r * nu_robot_stride + t * nu_bin_stride
template <typename Tex, typename Acc>
__global__ void corr_table_kernel(const Tex* __restrict__ tex, int hp, int wp,
                                  const int32_t* __restrict__ off,
                                  const int32_t* __restrict__ nu, int nu_robot_stride,
                                  int nu_bin_stride, const int32_t* __restrict__ t_n,
                                  const int32_t* __restrict__ org, Acc* __restrict__ out,
                                  int t_max, int n_beams, int rows) {
  __shared__ int32_t s_off[kTapChunk];
  const int t = blockIdx.x;
  const int dj = blockIdx.y;
  const int r = blockIdx.z;
  const int di = threadIdx.x;
  Acc acc = 0;
  if (t < t_n[r]) {
    const int n_taps = nu[r * nu_robot_stride + t * nu_bin_stride];
    const int row = org[2 * r] + dj;
    const int col = org[2 * r + 1] + di;
    const int32_t* taps = off + ((int64_t)r * t_max + t) * n_beams;
    for (int base = 0; base < n_taps; base += kTapChunk) {
      const int n = min(kTapChunk, n_taps - base);
      __syncthreads();
      for (int k = threadIdx.x; k < n; k += blockDim.x) s_off[k] = taps[base + k];
      __syncthreads();
      for (int k = 0; k < n; ++k) {
        const int32_t packed = s_off[k];
        const uint32_t w = (uint32_t)packed >> 20;
        const int oj = ((int32_t)((uint32_t)packed << 12)) >> 22;
        const int oi = ((int32_t)((uint32_t)packed << 22)) >> 22;
        // offsets are bounded by the prepass's range envelope; the clamp
        // only guards memory on inputs outside it
        const int rr = min(max(row + oj, 0), hp - 1);
        const int c = min(max(col + oi, 0), wp - 1);
        acc = tap_add(acc, w, tex[(int64_t)rr * wp + c]);
      }
    }
  }
  out[(((int64_t)r * t_max + t) * rows + dj) * kCols + di] = acc;
}

}  // namespace

extern "C" int corr_table_launch(const float* tex, int hp, int wp, const int32_t* off,
                                 const int32_t* nu, const int32_t* t_n,
                                 const int32_t* org, float* out, int t_max,
                                 int n_beams, int rows, void* stream) {
  dim3 grid(t_max, rows, 1);
  corr_table_kernel<float, float><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nu, t_max, 1, t_n, org, out, t_max, n_beams, rows);
  return (int)cudaGetLastError();
}

extern "C" int fleet_corr_table_launch(const float* tex, int hp, int wp,
                                       const int32_t* off, const int32_t* nv,
                                       const int32_t* t_n, const int32_t* org,
                                       float* out, int n_robots, int t_max,
                                       int n_beams, int rows, void* stream) {
  dim3 grid(t_max, rows, n_robots);
  corr_table_kernel<float, float><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nv, 1, 0, t_n, org, out, t_max, n_beams, rows);
  return (int)cudaGetLastError();
}

extern "C" int corr_table_q_launch(const int8_t* tex, int hp, int wp, const int32_t* off,
                                   const int32_t* nu, const int32_t* t_n,
                                   const int32_t* org, int32_t* out, int t_max,
                                   int n_beams, int rows, void* stream) {
  dim3 grid(t_max, rows, 1);
  corr_table_kernel<int8_t, int32_t><<<grid, kCols, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nu, t_max, 1, t_n, org, out, t_max, n_beams, rows);
  return (int)cudaGetLastError();
}
