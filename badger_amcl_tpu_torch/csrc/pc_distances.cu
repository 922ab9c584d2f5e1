// Voxel distance at every (cloud point, particle) pair.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/pc_kernel.py `_kernel`
// (via `_pc_call` / `windowed_distances`):
//
//   ex = px[m] + c qx[b] - s qy[b];  ey = py[m] + s qx[b] + c qy[b]
//   ci = floor(ex * inv_res + 0.5) - min_i;  cj likewise;  k = slab of qz[b]
//   out[b, m] = (ci, cj on the map ? tex[k, cj, ci] : 255) * max_ratio
//             = max_dist when k is outside the z band
//
// with c, s the particle's cos/sin yaw — the TPU kernel's own cell formula
// (pc_kernel.py:66-72) and value (:90, :221) over the z-major uint8 ratio
// texture (nz, ny, nx).
//
// Design: one thread per particle, a block of 256 particles walks a chunk
// of 32 points whose (qx, qy, slab) sit in shared memory; each point's row
// of the (B, M) output is written by consecutive threads, so stores
// coalesce, and each thread computes its particle's cos/sin once. The TPU
// kernel's per-point 64 x 256 windows and one-hot bf16 matmuls exist
// because a TPU lacks a fast gather; here each thread reads its voxel
// directly (the 3.4 MB texture of a 401 x 401 x 21 map stays in L2).
// Multiplies and adds are rounded separately in the plain PyTorch
// version's order, and cosf/sinf are the full-precision ones (no fast
// math), so kernel and plain version pick the same voxels.
//
// Bound on the H100: the (B, M) f32 output write — 51 MB at 256 x 50k,
// ~15 us at 3.35 TB/s; the texture reads are L2 hits.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 32;

__global__ void pc_distances_kernel(const uint8_t* __restrict__ tex, int nx, int ny,
                                    int nz, const float* __restrict__ poses, int m,
                                    const float* __restrict__ points, int n_points,
                                    float inv_res, int min_i, int min_j, int min_k,
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
    s_kz[k] = (int)floorf(__fadd_rn(__fmul_rn(q[2], inv_res), 0.5f)) - min_k;
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
    const float qx = s_qx[k];
    const float qy = s_qy[k];
    const int kz = s_kz[k];
    float z = max_dist;
    if (kz >= 0 && kz < nz) {
      const float ex = __fsub_rn(__fadd_rn(px, __fmul_rn(c, qx)), __fmul_rn(s, qy));
      const float ey = __fadd_rn(__fadd_rn(py, __fmul_rn(s, qx)), __fmul_rn(c, qy));
      const int ci = (int)floorf(__fadd_rn(__fmul_rn(ex, inv_res), 0.5f)) - min_i;
      const int cj = (int)floorf(__fadd_rn(__fmul_rn(ey, inv_res), 0.5f)) - min_j;
      float ratio = 255.0f;
      if (ci >= 0 && ci < nx && cj >= 0 && cj < ny) {
        ratio = (float)tex[((int64_t)kz * ny + cj) * nx + ci];
      }
      z = __fmul_rn(ratio, max_ratio);
    }
    out[(int64_t)(b0 + k) * m + p] = z;
  }
}

}  // namespace

extern "C" int pc_distances_launch(const uint8_t* tex, int nx, int ny, int nz,
                                   const float* poses, int m, const float* points,
                                   int n_points, float inv_res, int min_i, int min_j,
                                   int min_k, float max_ratio, float max_dist, float* out,
                                   void* stream) {
  dim3 grid((m + kThreads - 1) / kThreads, (n_points + kPoints - 1) / kPoints);
  pc_distances_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      tex, nx, ny, nz, poses, m, points, n_points, inv_res, min_i, min_j, min_k, max_ratio,
      max_dist, out);
  return (int)cudaGetLastError();
}
