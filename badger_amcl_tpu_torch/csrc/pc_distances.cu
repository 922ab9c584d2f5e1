// Voxel distances at the transformed cloud points, for converged and
// tracking clouds (the windowed arm).
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/pc_kernel.py `_kernel`
// (via `_pc_call` / `windowed_distances`), the XLA reductions of its
// prepass `window_origins` (pc_kernel.py:107-144) and the XLA combine over
// its (B, M) output (badger_amcl_tpu/sensors/point_cloud.py
// `_model_term_finalize`):
//
//   ex = px[m] + c qx[b] - s qy[b];  ey = py[m] + s qx[b] + c qy[b]
//   ci = floor(ex * inv_res + 0.5) - min_i;  cj likewise;  k = slab of qz[b]
//   z[b, m] = (ci, cj on the map ? tex[k, cj, ci] : 255) * max_ratio
//           = max_dist when k is outside the z band
//
// with c, s the particle's cos/sin yaw: the TPU kernel's own cell formula
// (pc_kernel.py:66-72) and value (:90, :221) over the z-major uint8 ratio
// texture (nz, ny, nx). Multiplies and adds are rounded separately in the
// plain PyTorch version's order, and cosf/sinf are the full-precision ones
// (no fast math), so kernel and plain version pick the same voxels. The
// TPU kernel's per-point 64 x 256 windows and one-hot bf16 matmuls exist
// because a TPU lacks a fast gather; here each thread reads its voxel
// directly (the 3.4 MB texture of a 401 x 401 x 21 map stays in L2).
// Three entry points share that cell function:
//
// - pc_extents_launch: the window prepass, per point the extents of its
//   in-map endpoint cells over the particles, (4, B) int32 rows ci_min,
//   ci_max, cj_min, cj_max, +-2^30 for a point with none. A block takes
//   1024 particles (4 per thread, cos/sin once each) and 16 points; per
//   point a warp reduction (__reduce_min/max_sync), the 8 warps' results
//   in shared memory, then one atomic per (block, point, extent) into the
//   initialised output: 784 blocks x 64 atomics at 50k x 256, not 12.8M
//   (16 points per block timed ahead of 32, and 4 particles per thread
//   ahead of 2 and 8). The wrapper finishes the TPU kernel's (32, 128)
//   alignment and fits test on the (B,) results. Bound: ~16 operations
//   per (particle, point);
// - pc_term_sums_launch: the windowed arm's likelihood, per particle the
//   sum over the points of the model's term at z, (M,) f32, nothing
//   (B, M) written. The term is looked up in a 257-entry table (the term
//   at the 256 ratios, then at max_dist; `ops/pc_kernel.term_table`, the
//   plain version's own expression), held as double in shared memory;
//   the terms are summed in double and rounded once. A block is 32
//   particles x 8 warps: warp w takes the points b = w (mod 8), so a warp
//   load reads one point's voxels for 32 particles of a converged cloud,
//   a few sectors of one slab, and eight threads per particle keep eight
//   loads in flight (8 warps timed ahead of 2 and 4); the warps' partials
//   are added in warp order. The points are staged per block in their own
//   order: over a windowed cloud each point's endpoints already fall in
//   one small patch. Bound: ~16 operations per (particle, point);
// - pc_distances_launch: z itself, (B, M) f32, the counterpart of the JAX
//   package's `windowed_distances` / `pc_distances_t`, which no main path
//   of the port launches. One thread per particle, a block of 256
//   particles walks a chunk of 32 points staged in shared memory, each
//   point's row written by consecutive threads. Bound: the 51 MB output
//   write at 256 x 50k, ~15 us at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 32;
constexpr int kBig = 1 << 30;
constexpr int kExtentPer = 4;      // particles per thread of the prepass
constexpr int kExtentPoints = 16;  // points per prepass block
constexpr int kSumWarps = 8;       // threads per particle of the sums
constexpr int kSumChunk = 256;     // points staged per chunk
constexpr int kTable = 257;        // 256 ratios, then outside the z band

struct Geom {
  int nx, ny, nz;
  float inv_res;
  int min_i, min_j, min_k;
};

__device__ __forceinline__ int slab_of(float qz, const Geom& g) {
  return (int)floorf(__fadd_rn(__fmul_rn(qz, g.inv_res), 0.5f)) - g.min_k;
}

// the texture-local cell of point (qx, qy) under particle (px, py, c, s);
// __float2int_rd is floor and the int conversion in one instruction
__device__ __forceinline__ void cell_of(float px, float py, float c, float s, float qx,
                                        float qy, const Geom& g, int& ci, int& cj) {
  const float ex = __fsub_rn(__fadd_rn(px, __fmul_rn(c, qx)), __fmul_rn(s, qy));
  const float ey = __fadd_rn(__fadd_rn(py, __fmul_rn(s, qx)), __fmul_rn(c, qy));
  ci = __float2int_rd(__fadd_rn(__fmul_rn(ex, g.inv_res), 0.5f)) - g.min_i;
  cj = __float2int_rd(__fadd_rn(__fmul_rn(ey, g.inv_res), 0.5f)) - g.min_j;
}

__device__ __forceinline__ bool on_map(int ci, int cj, const Geom& g) {
  return (unsigned)ci < (unsigned)g.nx && (unsigned)cj < (unsigned)g.ny;
}

__global__ void pc_distances_kernel(const uint8_t* __restrict__ tex,
                                    const float* __restrict__ poses, int m,
                                    const float* __restrict__ points, int n_points, Geom g,
                                    float max_ratio, float max_dist,
                                    float* __restrict__ out) {
  __shared__ float s_qx[kPoints];
  __shared__ float s_qy[kPoints];
  __shared__ int s_kz[kPoints];
  const int b0 = blockIdx.y * kPoints;
  const int n = min(kPoints, n_points - b0);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* q = points + 3 * (int64_t)(b0 + k);
    s_qx[k] = q[0];
    s_qy[k] = q[1];
    s_kz[k] = slab_of(q[2], g);
  }
  __syncthreads();
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= m) return;
  const float px = poses[3 * (int64_t)p];
  const float py = poses[3 * (int64_t)p + 1];
  const float th = poses[3 * (int64_t)p + 2];
  const float c = cosf(th);
  const float s = sinf(th);
  for (int k = 0; k < n; ++k) {
    const int kz = s_kz[k];
    float z = max_dist;
    if (kz >= 0 && kz < g.nz) {
      int ci, cj;
      cell_of(px, py, c, s, s_qx[k], s_qy[k], g, ci, cj);
      float ratio = 255.0f;
      if (on_map(ci, cj, g)) ratio = (float)tex[((int64_t)kz * g.ny + cj) * g.nx + ci];
      z = __fmul_rn(ratio, max_ratio);
    }
    out[(int64_t)(b0 + k) * m + p] = z;
  }
}

__global__ void pc_extents_init_kernel(int32_t* __restrict__ ext, int n_points) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 4 * n_points) ext[i] = (i / n_points) % 2 == 0 ? kBig : -kBig;
}

__global__ void __launch_bounds__(kThreads) pc_extents_kernel(
    const float* __restrict__ poses, int m, const float* __restrict__ points, int n_points,
    Geom g, int32_t* __restrict__ ext) {
  __shared__ float s_qx[kExtentPoints];
  __shared__ float s_qy[kExtentPoints];
  __shared__ int s_red[kThreads / 32][kExtentPoints][4];
  const int b0 = blockIdx.y * kExtentPoints;
  const int n = min(kExtentPoints, n_points - b0);
  for (int k = threadIdx.x; k < n; k += kThreads) {
    s_qx[k] = points[3 * (int64_t)(b0 + k)];
    s_qy[k] = points[3 * (int64_t)(b0 + k) + 1];
  }
  float px[kExtentPer], py[kExtentPer], c[kExtentPer], s[kExtentPer];
  bool live[kExtentPer];
#pragma unroll
  for (int j = 0; j < kExtentPer; ++j) {
    const int p = (blockIdx.x * kExtentPer + j) * kThreads + threadIdx.x;
    live[j] = p < m;
    px[j] = live[j] ? poses[3 * (int64_t)p] : 0.0f;
    py[j] = live[j] ? poses[3 * (int64_t)p + 1] : 0.0f;
    const float th = live[j] ? poses[3 * (int64_t)p + 2] : 0.0f;
    c[j] = cosf(th);
    s[j] = sinf(th);
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  for (int k = 0; k < n; ++k) {
    const float qx = s_qx[k];
    const float qy = s_qy[k];
    int lo_i = kBig, hi_i = -kBig, lo_j = kBig, hi_j = -kBig;
#pragma unroll
    for (int j = 0; j < kExtentPer; ++j) {
      int ci, cj;
      cell_of(px[j], py[j], c[j], s[j], qx, qy, g, ci, cj);
      if (live[j] && on_map(ci, cj, g)) {
        lo_i = min(lo_i, ci);
        hi_i = max(hi_i, ci);
        lo_j = min(lo_j, cj);
        hi_j = max(hi_j, cj);
      }
    }
    lo_i = __reduce_min_sync(0xffffffffu, lo_i);
    hi_i = __reduce_max_sync(0xffffffffu, hi_i);
    lo_j = __reduce_min_sync(0xffffffffu, lo_j);
    hi_j = __reduce_max_sync(0xffffffffu, hi_j);
    if ((threadIdx.x & 31) == 0) {
      s_red[warp][k][0] = lo_i;
      s_red[warp][k][1] = hi_i;
      s_red[warp][k][2] = lo_j;
      s_red[warp][k][3] = hi_j;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 4 * n; t += kThreads) {
    const int k = t / 4;
    const int e = t % 4;  // ci_min, ci_max, cj_min, cj_max
    int v = s_red[0][k][e];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) {
      v = e % 2 == 0 ? min(v, s_red[w][k][e]) : max(v, s_red[w][k][e]);
    }
    int32_t* dst = ext + (int64_t)e * n_points + b0 + k;
    if (e % 2 == 0 && v != kBig) atomicMin(dst, v);
    if (e % 2 == 1 && v != -kBig) atomicMax(dst, v);
  }
}

__global__ void __launch_bounds__(32 * kSumWarps) pc_term_sums_kernel(
    const uint8_t* __restrict__ tex, const float* __restrict__ poses, int m,
    const float* __restrict__ points, int n_points, Geom g, const float* __restrict__ table,
    float* __restrict__ out) {
  __shared__ double s_table[kTable];
  __shared__ float s_qx[kSumChunk];
  __shared__ float s_qy[kSumChunk];
  __shared__ int64_t s_base[kSumChunk];  // slab offset kz * ny * nx, -1 outside the band
  __shared__ double s_part[kSumWarps][32];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int warp = threadIdx.y;
  for (int k = tid; k < kTable; k += 32 * kSumWarps) s_table[k] = (double)table[k];
  const int i = blockIdx.x * 32 + threadIdx.x;
  const bool live = i < m;
  const float px = live ? poses[3 * (int64_t)i] : 0.0f;
  const float py = live ? poses[3 * (int64_t)i + 1] : 0.0f;
  const float th = live ? poses[3 * (int64_t)i + 2] : 0.0f;
  const float c = cosf(th);
  const float s = sinf(th);
  const int64_t slab = (int64_t)g.nx * g.ny;
  double acc = 0.0;
  for (int base = 0; base < n_points; base += kSumChunk) {
    const int n = min(kSumChunk, n_points - base);
    __syncthreads();
    for (int k = tid; k < n; k += 32 * kSumWarps) {
      const float* q = points + 3 * (int64_t)(base + k);
      const int kz = slab_of(q[2], g);
      s_qx[k] = q[0];
      s_qy[k] = q[1];
      s_base[k] = kz >= 0 && kz < g.nz ? kz * slab : -1;
    }
    __syncthreads();
    if (!live) continue;
#pragma unroll 4
    for (int k = warp; k < n; k += kSumWarps) {
      const int64_t off = s_base[k];
      int idx = kTable - 1;
      if (off >= 0) {
        int ci, cj;
        cell_of(px, py, c, s, s_qx[k], s_qy[k], g, ci, cj);
        idx = 255;
        if (on_map(ci, cj, g)) idx = __ldg(tex + off + (int64_t)cj * g.nx + ci);
      }
      acc += s_table[idx];
    }
  }
  s_part[warp][threadIdx.x] = acc;
  __syncthreads();
  if (warp == 0 && live) {
    double sum = s_part[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kSumWarps; ++w) sum += s_part[w][threadIdx.x];
    out[i] = (float)sum;
  }
}

Geom geom(int nx, int ny, int nz, float inv_res, int min_i, int min_j, int min_k) {
  return Geom{nx, ny, nz, inv_res, min_i, min_j, min_k};
}

}  // namespace

extern "C" int pc_distances_launch(const uint8_t* tex, int nx, int ny, int nz,
                                   const float* poses, int m, const float* points,
                                   int n_points, float inv_res, int min_i, int min_j,
                                   int min_k, float max_ratio, float max_dist, float* out,
                                   void* stream) {
  dim3 grid((m + kThreads - 1) / kThreads, (n_points + kPoints - 1) / kPoints);
  pc_distances_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tex, poses, m, points, n_points, geom(nx, ny, nz, inv_res, min_i, min_j, min_k),
      max_ratio, max_dist, out);
  return (int)cudaGetLastError();
}

extern "C" int pc_extents_launch(const float* poses, int m, const float* points, int n_points,
                                 int nx, int ny, float inv_res, int min_i, int min_j,
                                 int32_t* ext, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  pc_extents_init_kernel<<<(4 * n_points + 255) / 256, 256, 0, s>>>(ext, n_points);
  const int per_block = kThreads * kExtentPer;
  const dim3 grid((m + per_block - 1) / per_block,
                  (n_points + kExtentPoints - 1) / kExtentPoints);
  if (m > 0) {
    pc_extents_kernel<<<grid, kThreads, 0, s>>>(poses, m, points, n_points,
                                                geom(nx, ny, 0, inv_res, min_i, min_j, 0),
                                                ext);
  }
  return (int)cudaGetLastError();
}

extern "C" int pc_term_sums_launch(const uint8_t* tex, int nx, int ny, int nz,
                                   const float* poses, int m, const float* points,
                                   int n_points, float inv_res, int min_i, int min_j,
                                   int min_k, const float* table, float* out, void* stream) {
  pc_term_sums_kernel<<<(m + 31) / 32, dim3(32, kSumWarps), 0, (cudaStream_t)stream>>>(
      tex, poses, m, points, n_points, geom(nx, ny, nz, inv_res, min_i, min_j, min_k), table,
      out);
  return (int)cudaGetLastError();
}
