// Per-particle point-cloud term sums for spread particle clouds.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/pc_spread_kernel.py
// `_kernel3` (via `_tiered_call3` / `pc_spread_term_sums`): for every
// particle m
//
//   s[m] = sum_b table[k],  k = tex[k_b, cj, ci] (a uint8 ratio), 255 off
//          the map, 256 when the point's slab k_b is outside the z band,
//   ci   = floor(pxc + A_b ct - B_b st),  cj = floor(pyc + B_b ct + A_b st)
//
// with pxc = px * inv_res + (0.5 - min_i), ct/st the particle's cos/sin
// yaw and (A_b, B_b) = (qx_b, qy_b) * inv_res — the TPU kernel's endpoint
// formula (pc_spread_kernel.py:197-199, :445-446) and out-of-band constant
// (:595-597), over the z-major uint8 ratio texture (nz, ny, nx). `table`
// holds the model's term t(z) (pz^3 for likelihood_field, pz for
// Gompertz, pz = z_hit exp(-z^2 / denom) + zr) at z = q * max_ratio for
// the 256 ratios q (255 is also the off-map value) and at z = max_dist
// for entry 256, evaluated by the wrapper with the plain version's own
// torch expression on the same device, so each looked-up term equals the
// plain version's bit for bit.
//
// Output is in the ORIGINAL particle order: the TPU kernel's particle
// sort, window tiers, escape arm and unsort exist to make its one-hot MXU
// gathers dense, and a direct gather needs none of them (so there is no
// escape capacity or point-slot budget to overflow). The endpoint's
// multiplies and adds are rounded separately, in the plain version's
// order, and cosf/sinf are the full-precision ones (no fast math). The
// terms are summed in double and rounded once, so the sum does not depend
// on a summation order to within f32 rounding.
//
// Bound on the H100: ~12 operations per (particle, point) — 8 for the
// endpoint, two floors, the bounds test and the add — 12.8M pairs at 50k x
// 256, against 3.4 MB of texture and an M x 4 B output: operations. The
// per-pair expf, division and cube of the earlier design became one read
// of the table, held as double in shared memory so the accumulate takes no
// conversion. What bounds the kernel in fact is the texture gather: on a
// spread cloud the endpoints of one point scatter over the whole map, each
// read a separate L2 sector. Design:
//   - a one-block prep launch computes every point's (A, B, slab offset)
//     and writes them sorted by slab, then by 8-cell bins of (B, A) (the
//     TPU kernel's point sort `point_prep`, pc_spread_kernel.py:89-145,
//     with a position key where it buckets azimuth): points visited
//     together read one slab's neighbouring cells, which keeps the
//     texture lines they share in L1;
//   - kLanes neighbouring lanes of a warp share a particle, lane l taking
//     the sorted points b = l (mod kLanes), staged in shared memory, and
//     their double partials are added by xor shuffles in a fixed order.
//     The launcher takes 8 lanes where 4 would leave fewer than 1024
//     threads per SM (a 10,000-particle tracking cloud runs on 80,000
//     threads) and 4 otherwise (fewer blocks, each particle's cos/sin and
//     the staging shared by fewer lanes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPointChunk = 256;
constexpr int kTable = 257;  // 256 ratios, then outside the z band
constexpr int kPrepThreads = 1024;

// the point's cell offsets (A, B), its slab offset kz * ny * nx (-1
// outside the z band; 64-bit, as a map may hold 2^31 cells or more) and
// its sort key: slab, then 8-cell bins of B and A
__device__ __forceinline__ void point_of(const float* __restrict__ q, float inv_res, int min_k,
                                         int nz, int64_t slab, float& a, float& b,
                                         int64_t& base, int& key) {
  a = __fmul_rn(q[0], inv_res);
  b = __fmul_rn(q[1], inv_res);
  const int kz = (int)floorf(__fadd_rn(__fmul_rn(q[2], inv_res), 0.5f)) - min_k;
  const bool band = kz >= 0 && kz < nz;
  base = band ? kz * slab : -1;
  const int ia = min(max(((int)floorf(a) >> 3) + 128, 0), 255);
  const int ib = min(max(((int)floorf(b) >> 3) + 128, 0), 255);
  key = ((band ? kz : nz) << 16) | (ib << 8) | ia;
}

// one block: every point's (A, B, slab offset), written in key order, ties
// in index order (a rank count over the keys)
__global__ void __launch_bounds__(kPrepThreads) pc_spread_prep_kernel(
    const float* __restrict__ points, int n, float inv_res, int min_k, int nz, int64_t slab,
    int* __restrict__ keys, float* __restrict__ out_a, float* __restrict__ out_b,
    int64_t* __restrict__ out_base) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float a, b;
    int64_t base;
    int key;
    point_of(points + 3 * (int64_t)k, inv_res, min_k, nz, slab, a, b, base, key);
    keys[k] = key;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    float a, b;
    int64_t base;
    int key;
    point_of(points + 3 * (int64_t)k, inv_res, min_k, nz, slab, a, b, base, key);
    int rank = 0;
    for (int j = 0; j < n; ++j) {
      const int kj = keys[j];
      rank += kj < key || (kj == key && j < k);
    }
    out_a[rank] = a;
    out_b[rank] = b;
    out_base[rank] = base;
  }
}

template <int kLanes>
__global__ void __launch_bounds__(kThreads) pc_spread_term_sums_kernel(
    const uint8_t* __restrict__ tex, int nx, int ny, const float* __restrict__ poses, int m,
    const float* __restrict__ pa, const float* __restrict__ pb,
    const int64_t* __restrict__ pbase, int n_points, float inv_res, float off_x, float off_y,
    const float* __restrict__ table, float* __restrict__ out) {
  __shared__ double s_table[kTable];
  __shared__ float s_a[kPointChunk];
  __shared__ float s_b[kPointChunk];
  __shared__ int64_t s_base[kPointChunk];  // slab offset kz * ny * nx, -1 outside the band
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  for (int k = tid; k < kTable; k += kThreads) s_table[k] = (double)table[k];
  const int i = blockIdx.x * (kThreads / kLanes) + tid / kLanes;
  const bool live = i < m;
  float pxc = 0.0f, pyc = 0.0f, c = 0.0f, s = 0.0f;
  if (live) {
    pxc = __fadd_rn(__fmul_rn(poses[3 * (int64_t)i], inv_res), off_x);
    pyc = __fadd_rn(__fmul_rn(poses[3 * (int64_t)i + 1], inv_res), off_y);
    const float th = poses[3 * (int64_t)i + 2];
    c = cosf(th);
    s = sinf(th);
  }
  double acc = 0.0;
  for (int base = 0; base < n_points; base += kPointChunk) {
    const int n = min(kPointChunk, n_points - base);
    __syncthreads();
    for (int k = tid; k < n; k += kThreads) {
      s_a[k] = pa[base + k];
      s_b[k] = pb[base + k];
      s_base[k] = pbase[base + k];
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = lane; k < n; k += kLanes) {
      const int64_t off = s_base[k];
      int idx = kTable - 1;
      if (off >= 0) {
        const float a = s_a[k];
        const float b = s_b[k];
        const int ci = (int)floorf(__fsub_rn(__fadd_rn(pxc, __fmul_rn(a, c)), __fmul_rn(b, s)));
        const int cj = (int)floorf(__fadd_rn(__fadd_rn(pyc, __fmul_rn(b, c)), __fmul_rn(a, s)));
        idx = 255;
        if (ci >= 0 && ci < nx && cj >= 0 && cj < ny) {
          idx = __ldg(tex + off + (int64_t)cj * nx + ci);
        }
      }
      acc += s_table[idx];
    }
  }
#pragma unroll
  for (int w = kLanes / 2; w >= 1; w /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0 && live) out[i] = (float)acc;
}

template <int kLanes>
void launch_sums(const uint8_t* tex, int nx, int ny, const float* poses, int m, const float* pa,
                 const float* pb, const int64_t* pbase, int n_points, float inv_res, float off_x,
                 float off_y, const float* table, float* out, cudaStream_t stream) {
  constexpr int kPerBlock = kThreads / kLanes;
  pc_spread_term_sums_kernel<kLanes><<<(m + kPerBlock - 1) / kPerBlock, kThreads, 0, stream>>>(
      tex, nx, ny, poses, m, pa, pb, pbase, n_points, inv_res, off_x, off_y, table, out);
}

}  // namespace

// scratch: 5 * n_points int32 (the int64 slab offsets first, then keys, A, B)
extern "C" int pc_spread_term_sums_launch(const uint8_t* tex, int nx, int ny, int nz,
                                          const float* poses, int m, const float* points,
                                          int n_points, float inv_res, int min_i, int min_j,
                                          int min_k, const float* table, int* scratch,
                                          float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int64_t* pbase = (int64_t*)scratch;
  int* keys = scratch + 2 * (int64_t)n_points;
  float* pa = (float*)(scratch + 3 * (int64_t)n_points);
  float* pb = (float*)(scratch + 4 * (int64_t)n_points);
  if (n_points > 0) {
    pc_spread_prep_kernel<<<1, kPrepThreads, 0, s>>>(points, n_points, inv_res, min_k, nz,
                                                     (int64_t)nx * ny, keys, pa, pb, pbase);
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // (0.5 - min) is exact in f32 for any map a texture can hold
  const float ox = 0.5f - (float)min_i, oy = 0.5f - (float)min_j;
  if ((int64_t)m * 4 < (int64_t)sms * 1024) {
    launch_sums<8>(tex, nx, ny, poses, m, pa, pb, pbase, n_points, inv_res, ox, oy, table,
                   out, s);
  } else {
    launch_sums<4>(tex, nx, ny, poses, m, pa, pb, pbase, n_points, inv_res, ox, oy, table,
                   out, s);
  }
  return (int)cudaGetLastError();
}
