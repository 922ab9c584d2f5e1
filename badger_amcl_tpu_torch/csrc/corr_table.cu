// Stencil-correlation tables for the corr backends: two tap loops, three
// entry points.
//
// Replaces the Pallas TPU kernels of badger_amcl_tpu/ops/corr_kernel.py:
// - corr_table_launch: `_kernel_pre` (via `_corr_call_pre`) and `_kernel`
//   (via `_corr_call`), which share the tap loop `_bin_loop`;
// - corr_table_q_launch: `_kernel_q` (via `_corr_call_q`), the table over
//   the int8 ratio-quantized texture with int32 sums;
// - fleet_corr_table_launch: `_kernel_fleet` (via `fleet_corr_call`), the
//   f32 table for R robots in one call, with a kernel of its own.
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
// Every f32 cell adds its taps in tap order as `acc + w * v` with the
// multiply and the add rounded separately: the TPU kernels' own order and
// rounding, so a table agrees with theirs bit for bit. int8: `acc + w * q`
// in int32, exact in any order. Every window reads the one padded texture
// at its own origin: the TPU kernels' row-preshifted copies (eight f32,
// four int8), per-robot (512, 1024) slices, 8-row blocking and row rolls
// exist only for Mosaic's aligned vector loads and are not built here.
// t_n, the tap counts and the origins are read on the device, so launching
// needs no host sync.
//
// Single-robot tables (#1, #6): one block per (t, dj), one thread per di
// (128 = PWIN_C); the block stages its bin's taps in shared memory and each
// thread walks them. Bound on the H100: texture reads, taps x rows x 512 B
// of L2 traffic per table (~75 MB at 50k x 720, tracking).
//
// Fleet tables (#5): 256 robots x ~18 live bins x 180 taps x 32 x 128 cells
// = 3.4e9 adds. Its bound by operations (0.05 ms at 67 TFLOP/s) is out of
// reach of any gather: every (tap, cell) reads one 4-byte texel, 13.6 GB
// of L1 traffic, ~0.45 ms at ~30 TB/s over 132 SMs. What held the
// one-thread-per-cell loop back was instruction issue (~15 instructions
// per (tap, cell): decode, two clamps, a 64-bit address, the load, the
// convert, the multiply, the add) and blocks for dead bins (~72% of a
// fleet table). The design:
// - one block per (bin, robot); its 32 x (rows / kRowsPer) threads each
//   own kRowsPer rows and the kColGroups columns lane + 32 c, so a tap is
//   decoded once per thread and its kRowsPer x kColGroups texels are
//   read-only loads at fixed offsets from one base (a warp reads 128
//   contiguous bytes per load);
// - the block first reduces its bin's tap offset extent: when every tap
//   keeps the whole window inside the texture (the prepass's range_ok
//   envelope guarantees it) no read is clamped at all; otherwise a
//   per-element clamp loop keeps any input memory-safe, with the plain
//   version's values;
// - every tap is a unit tap (the fleet prepass does not deduplicate), so
//   the weight field is not read and a cell adds its texels, exactly
//   acc + 1 * v; the TPU fleet kernel reads no weight either;
// - dead bins (t >= t_n) are zeroed with 16-byte stores.
// Staging each block's texture band in shared memory instead (conflict-free
// reads at any column offset) measured no faster: the read-only path
// already serves a misaligned 128-byte warp read at about one L1 wavefront.

#include <cuda_runtime.h>
#include <limits.h>
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

__device__ __forceinline__ void decode(int32_t packed, uint32_t& w, int& oj, int& oi) {
  w = (uint32_t)packed >> 20;
  oj = ((int32_t)((uint32_t)packed << 12)) >> 22;
  oi = ((int32_t)((uint32_t)packed << 22)) >> 22;
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
        uint32_t w;
        int oj, oi;
        decode(s_off[k], w, oj, oi);
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

// --- fleet tables ------------------------------------------------------------

constexpr int kRowsPer = 2;    // rows per thread
constexpr int kColGroups = 4;  // columns lane + 32 c per thread
constexpr int kFleetTapChunk = 512;
constexpr int kMaxFleetThreads = 32 * 64 / kRowsPer;

using Tile = float[kRowsPer][kColGroups];

// the block's taps [0, n) into shared memory: each tap's texel offset
// oj * wp + oi from the thread's base or, with `clamped`, the packed tap
__device__ __forceinline__ void load_taps(const int32_t* __restrict__ taps, int n, bool clamped,
                                          int wp, int32_t* s_d) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int k = tid; k < n; k += nthreads) {
    const int32_t packed = __ldg(taps + k);
    uint32_t w;
    int oj, oi;
    decode(packed, w, oj, oi);
    s_d[k] = clamped ? packed : oj * wp + oi;
  }
  __syncthreads();
}

__device__ __forceinline__ void taps_global(const float* __restrict__ base, int stride,
                                            const int32_t* s_d, int n, Tile& acc) {
  for (int k = 0; k < n; ++k) {
    const float* p = base + s_d[k];
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
#pragma unroll
      for (int c = 0; c < kColGroups; ++c) {
        acc[r][c] = __fadd_rn(acc[r][c], __ldg(p + r * stride + 32 * c));
      }
    }
  }
}

// outside the envelope: every texel clamped into the texture, as the plain
// version clamps it
__device__ __forceinline__ void taps_clamped(const float* __restrict__ tex, int hp, int wp,
                                             int row, int col, const int32_t* s_d, int n,
                                             Tile& acc) {
  for (int k = 0; k < n; ++k) {
    uint32_t w;
    int oj, oi;
    decode(s_d[k], w, oj, oi);
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const int rr = min(max(row + r + oj, 0), hp - 1);
#pragma unroll
      for (int c = 0; c < kColGroups; ++c) {
        const int cc = min(max(col + 32 * c + oi, 0), wp - 1);
        acc[r][c] = __fadd_rn(acc[r][c], __ldg(tex + (int64_t)rr * wp + cc));
      }
    }
  }
}

__global__ void __launch_bounds__(kMaxFleetThreads) fleet_corr_table_kernel(
    const float* __restrict__ tex, int hp, int wp, const int32_t* __restrict__ off,
    const int32_t* __restrict__ nv, const int32_t* __restrict__ t_n,
    const int32_t* __restrict__ org, float* __restrict__ out, int t_max, int n_beams,
    int rows) {
  __shared__ int32_t s_d[kFleetTapChunk];
  __shared__ int s_ext[4];  // oj_lo, oj_hi, oi_lo, oi_hi over the bin's taps
  const int t = blockIdx.x;
  const int r = blockIdx.y;
  const int lane = threadIdx.x;
  const int tid = threadIdx.y * 32 + lane;
  const int nthreads = blockDim.x * blockDim.y;
  const int64_t table = (int64_t)rows * kCols;
  float* out_t = out + ((int64_t)r * t_max + t) * table;

  if (t >= t_n[r]) {
    float4* z = reinterpret_cast<float4*>(out_t);
    for (int i = tid; i < rows * kCols / 4; i += nthreads) z[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  const int nb = min(nv[r], n_beams);
  const int row0 = org[2 * r];
  const int col0 = org[2 * r + 1];
  const int32_t* taps = off + ((int64_t)r * t_max + t) * n_beams;

  // offset extent of the bin's taps
  int ext[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  for (int k = tid; k < nb; k += nthreads) {
    uint32_t w;
    int oj, oi;
    decode(__ldg(taps + k), w, oj, oi);
    ext[0] = min(ext[0], oj);
    ext[1] = max(ext[1], oj);
    ext[2] = min(ext[2], oi);
    ext[3] = max(ext[3], oi);
  }
  if (tid < 4) s_ext[tid] = (tid % 2 == 0) ? INT_MAX : INT_MIN;
  __syncthreads();
  const int lo_j = __reduce_min_sync(0xffffffffu, ext[0]);
  const int hi_j = __reduce_max_sync(0xffffffffu, ext[1]);
  const int lo_i = __reduce_min_sync(0xffffffffu, ext[2]);
  const int hi_i = __reduce_max_sync(0xffffffffu, ext[3]);
  if (lane == 0) {
    atomicMin(&s_ext[0], lo_j);
    atomicMax(&s_ext[1], hi_j);
    atomicMin(&s_ext[2], lo_i);
    atomicMax(&s_ext[3], hi_i);
  }
  __syncthreads();
  // with no tap (nb == 0) the extent stays empty and every read is inside
  const bool clamped = nb > 0 && !(row0 + s_ext[0] >= 0 && row0 + rows - 1 + s_ext[1] <= hp - 1 &&
                                   col0 + s_ext[2] >= 0 && col0 + kCols - 1 + s_ext[3] <= wp - 1);

  // the thread's first row and column in the window
  const int dj0 = threadIdx.y * kRowsPer;
  const float* base = tex + (int64_t)(row0 + dj0) * wp + col0 + lane;
  Tile acc;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int c = 0; c < kColGroups; ++c) acc[i][c] = 0.f;
  for (int b0 = 0; b0 < nb; b0 += kFleetTapChunk) {
    const int n = min(kFleetTapChunk, nb - b0);
    if (b0 > 0) __syncthreads();  // the previous chunk is consumed
    load_taps(taps + b0, n, clamped, wp, s_d);
    if (clamped) taps_clamped(tex, hp, wp, row0 + dj0, col0 + lane, s_d, n, acc);
    else taps_global(base, wp, s_d, n, acc);
  }
  float* o = out_t + (int64_t)dj0 * kCols + lane;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int c = 0; c < kColGroups; ++c) o[i * kCols + 32 * c] = acc[i][c];
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

// grid (t_max, n_robots), 32 x rows / kRowsPer threads
extern "C" int fleet_corr_table_launch(const float* tex, int hp, int wp,
                                       const int32_t* off, const int32_t* nv,
                                       const int32_t* t_n, const int32_t* org,
                                       float* out, int n_robots, int t_max,
                                       int n_beams, int rows, void* stream) {
  if (rows % kRowsPer != 0 || rows / kRowsPer * 32 > kMaxFleetThreads) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(t_max, n_robots, 1);
  dim3 block(32, rows / kRowsPer, 1);
  fleet_corr_table_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nv, t_n, org, out, t_max, n_beams, rows);
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
