// Distance-field value at every (beam, particle) scan endpoint.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/lf_kernel.py `_kernel`
// (via `windowed_distance_gather` / `lf_distances_t`):
//
//   th = pth[m] + a[b];  hx = px[m] + r[b] cos(th);  hy = py[m] + r[b] sin(th)
//   ci = floor((hx - ox) / res + 0.5) + half_x   (world_to_map,
//   cj = floor((hy - oy) / res + 0.5) + half_y    occupancy_map.cpp:90-98)
//   z[b, m] = tex[cj, ci] if (ci, cj) is on the map else max_dist
//
// templated over the texture type: the bf16 texture reproduces the TPU
// kernel's contract (its one-hot MXU pick returns the bf16 cell value
// exactly), the f32 texture the exact gather the JAX package takes when
// the per-beam window does not fit.
//
// Design: one thread per (b, m), m fastest, so (B, M) stores coalesce. The
// TPU kernel's per-beam texture windows and one-hot matmuls exist because
// TPUs lack a fast gather; here each thread reads its cell directly.
// Multiplies, adds and the division are rounded separately and cosf/sinf
// are the full-precision ones (no fast math), matching the plain PyTorch
// version.
//
// Bound on the H100: the (B, M) f32 output write — 144 MB at 720 x 50k,
// ~43 us at 3.35 TB/s — plus one scattered texture read per element (a
// 1024^2 texture is 2 MB in bf16, 4 MB in f32, L2-resident).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void lf_distances_kernel(const T* __restrict__ tex, const float* __restrict__ px,
                                    const float* __restrict__ py,
                                    const float* __restrict__ pth, int m,
                                    const float* __restrict__ ranges,
                                    const float* __restrict__ angles, int n_beams,
                                    float res, float ox, float oy, int half_x, int half_y,
                                    int size_x, int size_y, float max_dist,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)m * n_beams) return;
  const int b = (int)(i / m);
  const int p = (int)(i - (int64_t)b * m);
  const float r = ranges[b];
  const float th = __fadd_rn(pth[p], angles[b]);
  const float hx = __fadd_rn(px[p], __fmul_rn(r, cosf(th)));
  const float hy = __fadd_rn(py[p], __fmul_rn(r, sinf(th)));
  const int ci = (int)floorf(__fadd_rn(__fdiv_rn(__fsub_rn(hx, ox), res), 0.5f)) + half_x;
  const int cj = (int)floorf(__fadd_rn(__fdiv_rn(__fsub_rn(hy, oy), res), 0.5f)) + half_y;
  float z = max_dist;
  if (ci >= 0 && ci < size_x && cj >= 0 && cj < size_y) {
    z = to_float(tex[(int64_t)cj * size_x + ci]);
  }
  out[i] = z;
}

template <typename T>
int launch(const T* tex, const float* px, const float* py, const float* pth, int m,
           const float* ranges, const float* angles, int n_beams, float res, float ox,
           float oy, int half_x, int half_y, int size_x, int size_y, float max_dist,
           float* out, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)m * n_beams;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  lf_distances_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tex, px, py, pth, m, ranges, angles, n_beams, res, ox, oy, half_x, half_y, size_x,
      size_y, max_dist, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lf_distances_f32_launch(const float* tex, const float* px, const float* py,
                                       const float* pth, int m, const float* ranges,
                                       const float* angles, int n_beams, float res,
                                       float ox, float oy, int half_x, int half_y,
                                       int size_x, int size_y, float max_dist, float* out,
                                       void* stream) {
  return launch<float>(tex, px, py, pth, m, ranges, angles, n_beams, res, ox, oy, half_x,
                       half_y, size_x, size_y, max_dist, out, stream);
}

extern "C" int lf_distances_bf16_launch(const void* tex, const float* px, const float* py,
                                        const float* pth, int m, const float* ranges,
                                        const float* angles, int n_beams, float res,
                                        float ox, float oy, int half_x, int half_y,
                                        int size_x, int size_y, float max_dist,
                                        float* out, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)tex, px, py, pth, m, ranges, angles,
                               n_beams, res, ox, oy, half_x, half_y, size_x, size_y,
                               max_dist, out, stream);
}
