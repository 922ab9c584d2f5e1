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
// Single-robot tables (#1, #6): at 50k x 720 a table has 10-21 live bins
// of ~250 deduplicated taps over 24-32 rows, 7.7M-20.7M (tap, cell) pairs
// in only 31k-86k live cells, so few warps per SM. Their floor is one
// texel per (tap, cell) from L1 (~0.003 ms); what holds them back on an
// H100 looks like latency: a cell's taps walk the scan's ring stencil, each
// new texture row is a trip to L2, and the few warps cannot hide it. The
// design:
// - one block per (bin, R rows x C columns); the block stages the bin's
//   taps in shared memory once, as (byte offset of the texel from a cell's
//   own, weight) pairs, and reduces their extent: inside the prepass's
//   envelope no read is clamped and each tap costs a thread one broadcast
//   shared load, one 64-bit add, the load and its multiply-add; a clamped
//   loop keeps any other input memory-safe with the plain version's values;
// - U taps' loads are issued before their adds, which stay in tap order;
// - #1 (f32) takes 2 x 32 cells per block, one per thread (many small
//   blocks over the 132 SMs, each block's rows sharing texture lines in
//   L1); #6 (int8, exact int32 sums) one row of 128 cells, four per thread,
//   its taps split over 8 warps whose partial sums meet in shared memory;
// - dead bins (t >= t_n) are zeroed with 16-byte stores by one block each.
// Timed in turns on an H100 80GB HBM3 (700 W) against nine other layouts
// (R = 1-8 rows, 32-128 columns, 1 or 4 columns per thread, 8-32 taps
// ahead, 1-8 tap splits; chip_ab.py), these won at the steady 24-row and
// tracking 32-row shapes. Neither an L1 prefetch of the block's lines, a
// larger L1 share nor smaller tap chunks measured faster.
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

__device__ __forceinline__ void decode(int32_t packed, uint32_t& w, int& oj, int& oi) {
  w = (uint32_t)packed >> 20;
  oj = ((int32_t)((uint32_t)packed << 12)) >> 22;
  oi = ((int32_t)((uint32_t)packed << 22)) >> 22;
}

// --- single-robot tables (#1, #6) -------------------------------------------

// Block (x, t): bin t, window rows [g R, g R + R) and columns [h C, h C + C)
// for x = g (PWIN_C / C) + h. Its threads: 32 lanes x C / (32 CB) column
// warps x R row warps x S tap splits; a thread owns one row and the CB
// columns lane + 32 (cw + c C / (32 CB)) of the block's strip, so a warp
// reads 32 neighbouring texels per load. S > 1 splits the bin's taps into S
// contiguous ranges whose int32 partial sums meet in shared memory (exact
// in any order); the f32 table keeps S = 1, every cell adding its taps in
// tap order.
template <int R, int C, int CB, int S>
struct Layout {
  static constexpr int kColWarps = C / (32 * CB);
  static constexpr int kThreads = 32 * kColWarps * R * S;
  static_assert(kCols % C == 0 && C % (32 * CB) == 0, "C divides PWIN_C, 32 CB divides C");
  static_assert(kThreads <= 1024, "at most 1024 threads");
};

// a staged tap's weight: f32 bits for the f32 table, int32 for the int8 one
__device__ __forceinline__ int32_t weight_bits(float, uint32_t w) {
  return __float_as_int((float)w);
}
__device__ __forceinline__ int32_t weight_bits(int32_t, uint32_t w) { return (int32_t)w; }

__device__ __forceinline__ float tap_add(float acc, int32_t wb, float v) {
  return __fadd_rn(acc, __fmul_rn(__int_as_float(wb), v));
}
__device__ __forceinline__ int32_t tap_add(int32_t acc, int32_t w, int8_t v) {
  return acc + w * (int32_t)v;
}

// the texel `off` bytes past p
template <typename Tex>
__device__ __forceinline__ Tex texel(const Tex* p, int off) {
  return __ldg(reinterpret_cast<const Tex*>(reinterpret_cast<const char*>(p) + off));
}

// Stage taps [0, n) of the chunk: s_tap[k] = (byte offset (oj wp + oi) x
// sizeof(Tex) of its texel from a cell's own, weight), s_pk[k] the packed
// tap. Returns whether some read of the block's R x C cells at (row0, col0)
// leaves the texture, or a staged offset would not fit in 32 bits: then the
// clamped loop runs.
template <typename Tex, typename Acc, int R, int C>
__device__ bool stage_taps(const int32_t* __restrict__ taps, int n, int hp, int wp, int row0,
                           int col0, int tid, int nthreads, int2* s_tap, int32_t* s_pk,
                           int* s_ext) {
  __syncthreads();  // the previous chunk and its extent are consumed
  if (tid < 4) s_ext[tid] = (tid % 2 == 0) ? INT_MAX : INT_MIN;
  __syncthreads();
  int ext[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
  for (int k = tid; k < n; k += nthreads) {
    const int32_t packed = __ldg(taps + k);
    uint32_t w;
    int oj, oi;
    decode(packed, w, oj, oi);
    ext[0] = min(ext[0], oj);
    ext[1] = max(ext[1], oj);
    ext[2] = min(ext[2], oi);
    ext[3] = max(ext[3], oi);
    s_tap[k] = make_int2((int32_t)(((int64_t)oj * wp + oi) * (int64_t)sizeof(Tex)),
                         weight_bits(Acc(), w));
    s_pk[k] = packed;
  }
  ext[0] = __reduce_min_sync(0xffffffffu, ext[0]);
  ext[1] = __reduce_max_sync(0xffffffffu, ext[1]);
  ext[2] = __reduce_min_sync(0xffffffffu, ext[2]);
  ext[3] = __reduce_max_sync(0xffffffffu, ext[3]);
  if ((tid & 31) == 0) {
    atomicMin(&s_ext[0], ext[0]);
    atomicMax(&s_ext[1], ext[1]);
    atomicMin(&s_ext[2], ext[2]);
    atomicMax(&s_ext[3], ext[3]);
  }
  __syncthreads();
  // |oj| <= 512: the offsets fit in 32 bits up to this texture width; a
  // wider texture takes the clamped loop, whose indices are 64-bit
  const bool narrow = wp <= INT_MAX / (1024 * (int)sizeof(Tex));
  return !(narrow && row0 + s_ext[0] >= 0 && row0 + R - 1 + s_ext[1] <= hp - 1 &&
           col0 + s_ext[2] >= 0 && col0 + C - 1 + s_ext[3] <= wp - 1);
}

// inside the envelope: U taps' texels are loaded before their adds, which
// run in tap order; every read is a fixed offset from the thread's cells
template <int CB, int CS, int U, typename Tex, typename Acc>
__device__ __forceinline__ void taps_fast(const Tex* p, const int2* s_tap, int k, int k1,
                                          Acc (&acc)[CB]) {
  for (; k + U <= k1; k += U) {
    int2 tp[U];
    Tex v[U][CB];
#pragma unroll
    for (int u = 0; u < U; ++u) tp[u] = s_tap[k + u];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CB; ++c) v[u][c] = texel(p + CS * c, tp[u].x);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] = tap_add(acc[c], tp[u].y, v[u][c]);
  }
  for (; k < k1; ++k) {
    const int2 tp = s_tap[k];
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[c] = tap_add(acc[c], tp.y, texel(p + CS * c, tp.x));
  }
}

// outside the envelope: every texel clamped into the texture, as the plain
// version clamps it
template <int CB, int CS, typename Tex, typename Acc>
__device__ __forceinline__ void taps_clamped(const Tex* __restrict__ tex, int hp, int wp,
                                             int row, int col, const int2* s_tap,
                                             const int32_t* s_pk, int k, int k1,
                                             Acc (&acc)[CB]) {
  for (; k < k1; ++k) {
    uint32_t w;
    int oj, oi;
    decode(s_pk[k], w, oj, oi);
    const int32_t wb = s_tap[k].y;
    const int rr = min(max(row + oj, 0), hp - 1);
#pragma unroll
    for (int c = 0; c < CB; ++c) {
      const int cc = min(max(col + CS * c + oi, 0), wp - 1);
      acc[c] = tap_add(acc[c], wb, __ldg(tex + (int64_t)rr * wp + cc));
    }
  }
}

template <typename Tex, typename Acc, int R, int C, int CB, int S, int U>
__global__ void __launch_bounds__(Layout<R, C, CB, S>::kThreads) corr_table_kernel(
    const Tex* __restrict__ tex, int hp, int wp, const int32_t* __restrict__ off,
    const int32_t* __restrict__ nu, const int32_t* __restrict__ t_n,
    const int32_t* __restrict__ org, Acc* __restrict__ out, int n_beams, int rows) {
  using L = Layout<R, C, CB, S>;
  constexpr int CW = L::kColWarps;
  constexpr int CS = 32 * CW;  // column stride of a thread's CB columns
  __shared__ int2 s_tap[kTapChunk];
  __shared__ int32_t s_pk[kTapChunk];
  __shared__ int s_ext[4];
  __shared__ Acc s_part[S > 1 ? (S - 1) * R * C : 1];
  const int t = blockIdx.y;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  Acc* out_t = out + (int64_t)t * rows * kCols;
  if (t >= __ldg(t_n)) {
    // a dead bin: its first block zeroes it with 16-byte stores
    if (blockIdx.x == 0) {
      int4* z = reinterpret_cast<int4*>(out_t);
      for (int i = tid; i < rows * kCols / 4; i += L::kThreads) z[i] = make_int4(0, 0, 0, 0);
    }
    return;
  }
  const int g = blockIdx.x / (kCols / C);
  const int h = blockIdx.x % (kCols / C);
  const int cw = threadIdx.y % CW;
  const int dj = (threadIdx.y / CW) % R;  // the thread's row in the block
  const int s = threadIdx.y / (CW * R);
  const int n_taps = min(__ldg(nu + t), n_beams);
  const int row0 = __ldg(org) + g * R;      // the block's first texture row
  const int col0 = __ldg(org + 1) + h * C;  // and column
  const int dc = threadIdx.x + 32 * cw;     // the thread's first column in the block
  const int32_t* taps = off + (int64_t)t * n_beams;
  const Tex* p = tex + (int64_t)(row0 + dj) * wp + col0 + dc;
  Acc acc[CB];
#pragma unroll
  for (int c = 0; c < CB; ++c) acc[c] = 0;
  for (int base = 0; base < n_taps; base += kTapChunk) {
    const int n = min(kTapChunk, n_taps - base);
    const bool clamped = stage_taps<Tex, Acc, R, C>(taps + base, n, hp, wp, row0, col0, tid,
                                                    L::kThreads, s_tap, s_pk, s_ext);
    const int k0 = s * n / S;
    const int k1 = (s + 1) * n / S;
    if (clamped) {
      taps_clamped<CB, CS>(tex, hp, wp, row0 + dj, col0 + dc, s_tap, s_pk, k0, k1, acc);
    } else {
      taps_fast<CB, CS, U>(p, s_tap, k0, k1, acc);
    }
  }
  if constexpr (S > 1) {
    // split s > 0 hands its partial sums to split 0, which adds them in
    // split order
    if (s > 0) {
#pragma unroll
      for (int c = 0; c < CB; ++c) s_part[((s - 1) * R + dj) * C + dc + CS * c] = acc[c];
    }
    __syncthreads();
    if (s > 0) return;
#pragma unroll
    for (int q = 0; q < S - 1; ++q)
#pragma unroll
      for (int c = 0; c < CB; ++c) acc[c] += s_part[(q * R + dj) * C + dc + CS * c];
  }
  Acc* o = out_t + (int64_t)(g * R + dj) * kCols + h * C + dc;
#pragma unroll
  for (int c = 0; c < CB; ++c) o[CS * c] = acc[c];
}

// grid (rows / R x PWIN_C / C, t_max): a bin's blocks are adjacent and the
// live bins (t < t_n) come first in launch order
template <typename Tex, typename Acc, int R, int C, int CB, int S, int U>
int launch_table(const Tex* tex, int hp, int wp, const int32_t* off, const int32_t* nu,
                 const int32_t* t_n, const int32_t* org, Acc* out, int t_max, int n_beams,
                 int rows, void* stream) {
  using L = Layout<R, C, CB, S>;
  if (rows % R != 0) return (int)cudaErrorInvalidValue;
  dim3 grid(rows / R * (kCols / C), t_max, 1);
  dim3 block(32, L::kThreads / 32, 1);
  corr_table_kernel<Tex, Acc, R, C, CB, S, U><<<grid, block, 0, (cudaStream_t)stream>>>(
      tex, hp, wp, off, nu, t_n, org, out, n_beams, rows);
  return (int)cudaGetLastError();
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

// #1: 2 rows x 32 columns per block (64 threads), one cell per thread, 16
// taps' loads ahead of their adds
extern "C" int corr_table_launch(const float* tex, int hp, int wp, const int32_t* off,
                                 const int32_t* nu, const int32_t* t_n,
                                 const int32_t* org, float* out, int t_max,
                                 int n_beams, int rows, void* stream) {
  return launch_table<float, float, 2, 32, 1, 1, 16>(tex, hp, wp, off, nu, t_n, org, out,
                                                     t_max, n_beams, rows, stream);
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

// #6: one row x 128 columns per block, four columns per thread, the bin's
// taps split over 8 warps (256 threads)
extern "C" int corr_table_q_launch(const int8_t* tex, int hp, int wp, const int32_t* off,
                                   const int32_t* nu, const int32_t* t_n,
                                   const int32_t* org, int32_t* out, int t_max,
                                   int n_beams, int rows, void* stream) {
  return launch_table<int8_t, int32_t, 1, 128, 4, 8, 8>(tex, hp, wp, off, nu, t_n, org, out,
                                                        t_max, n_beams, rows, stream);
}
