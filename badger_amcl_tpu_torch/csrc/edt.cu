// The maps' distance fields, built on the card at map receipt: the 2D
// capped field of an occupancy grid and the 3D uint8 voxel texture.
//
// Replaces the JAX package's native host hook badger_amcl_tpu/utils/
// native.py:68 `edt_cells` (`amcl_edt_2d` / `amcl_edt_3d`, native/
// amcl_host.cpp:97-130) and the capping and quantization its callers apply
// (badger_amcl_tpu/maps/edt.py:103-124 `capped_distance_field`,
// badger_amcl_tpu/maps/octomap_3d.py:136-141):
//
//   2D: out = d <= cell_radius ? d * res : max_dist, in double, to f32
//   3D: out = floor(min(d * res, max) / max * 255), in double, to uint8
//
// with d the Euclidean distance in cells to the nearest source (2D: an
// OCCUPIED cell, int8 1; 3D: a nonzero voxel). Only what the maps read is
// computed, not the uncapped EDT: each axis in turn takes the windowed
// minimum g'(q) = min over |q - v| <= R of g(v) + (q - v)^2 in int32, one
// thread per output cell, values above R^2 replaced by kFar after every
// pass. By induction over the passes, a cell whose true d^2 is <= R^2 gets
// it exactly (its nearest source's offsets lie inside every window, and
// every partial value is <= d^2); any other cell gets a value above R^2.
// The wrapper picks R so that every cell beyond it reads the cap: 2D R =
// cell_radius; 3D R = floor(max / res) + 1, raised while R * res < max
// (0.3 / 0.05 is 5.999... in double, so a cell at sqrt(35) is not capped).
// kFar + R^2 stays below 2^31 for R <= 16384, which the wrapper checks.
//
// The last pass finishes in double with each operation rounded on its
// own (sqrt is correctly rounded, __dmul_rn / __ddiv_rn cannot contract),
// so the results are bit-equal to the numpy reference.
//
// Bound: the bytes the function must move are the input and the output
// (2D 5, 3D 2 bytes a cell); the design also writes and reads an int32
// intermediate per pass (2D 13, 3D 18 bytes a cell), 0.65 ms for 120M
// voxels at 3.35 TB/s. The taps are 2R + 1 reads per cell and pass, served
// by L1 and L2: consecutive threads take consecutive cells of the
// contiguous axis, so each tap of a warp is one coalesced load, along the
// strided axes too. The passes run from the outermost axis in, so the
// widest stride reads the map's bytes rather than int32 (13 byte planes
// of the 2000 x 1200 store are 31 MB, within L2). Each pass takes ~1 ms on
// that 120M-voxel store, above its bytes' time (PERF.md): each thread
// also divides its 64-bit index for its coordinate and loops over 2R + 1
// taps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kFar = 1 << 30;  // no source within the window

int blocks(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

// The first pass, along the outermost axis (`stride` elements, length
// len): the squared offset of the nearest source within R on the line, or
// kFar, from the map's bytes.
__global__ void edt_first_kernel(const uint8_t* __restrict__ src, int64_t n, int64_t stride,
                                 int len, int r, int source_is_one, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int c = (int)((i / stride) % len);
  const int lo = max(-r, -c), hi = min(r, len - 1 - c);
  int32_t best = kFar;
  const uint8_t* p = src + i + lo * stride;
  for (int o = lo; o <= hi; ++o, p += stride) {
    const bool source = source_is_one ? *p == 1 : *p != 0;
    if (source) best = min(best, o * o);
  }
  out[i] = best;
}

// The windowed minimum of g(v) + (q - v)^2 along an axis of `stride`
// elements and length `len`, values above r2 set to kFar.
__device__ __forceinline__ int32_t window_min(const int32_t* __restrict__ g, int64_t i,
                                              int64_t stride, int len, int r, int32_t r2) {
  const int c = (int)((i / stride) % len);
  const int lo = max(-r, -c), hi = min(r, len - 1 - c);
  int32_t best = kFar;
  const int32_t* p = g + i + lo * stride;
  for (int o = lo; o <= hi; ++o, p += stride) best = min(best, *p + o * o);
  return best > r2 ? kFar : best;
}

__global__ void edt_axis_kernel(const int32_t* __restrict__ g, int64_t n, int64_t stride,
                                int len, int r, int32_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = window_min(g, i, stride, len, r, r * r);
}

// The 2D field's last pass: d <= cell_radius ? d * res : max_dist, the
// window r being cell_radius.
__global__ void edt_field_2d_kernel(const int32_t* __restrict__ g, int64_t n, int64_t stride,
                                    int len, int r, double res, double max_dist,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const double d = sqrt((double)window_min(g, i, stride, len, r, r * r));
  out[i] = __double2float_rn(d <= (double)r ? __dmul_rn(d, res) : max_dist);
}

// The 3D texture's last pass: floor(min(d * res, max) / max * 255).
__global__ void edt_texture_3d_kernel(const int32_t* __restrict__ g, int64_t n,
                                      int64_t stride, int len, int r, double res,
                                      double max_dist, uint8_t* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const double d = sqrt((double)window_min(g, i, stride, len, r, r * r));
  const double dm = fmin(__dmul_rn(d, res), max_dist);
  out[i] = (uint8_t)floor(__dmul_rn(__ddiv_rn(dm, max_dist), 255.0));
}

}  // namespace

// cells: int8 (h, w) CellState grid; r: cell_radius; scratch: int32 (h, w);
// out: f32 (h, w). Two launches: along h, then along w with the cap.
extern "C" int edt_2d_launch(const int8_t* cells, int h, int w, int r, double res,
                             double max_dist, int32_t* scratch, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)h * w;
  edt_first_kernel<<<blocks(n), kThreads, 0, s>>>((const uint8_t*)cells, n, w, h, r, 1,
                                                  scratch);
  edt_field_2d_kernel<<<blocks(n), kThreads, 0, s>>>(scratch, n, 1, w, r, res, max_dist,
                                                     out);
  return (int)cudaGetLastError();
}

// occ: uint8 (a, b, c), nonzero where occupied; scratch_a, scratch_b: int32
// (a, b, c); out: uint8 (a, b, c). Three launches: along a, b, then c with
// the quantization.
extern "C" int edt_3d_launch(const uint8_t* occ, int a, int b, int c, int r, double res,
                             double max_dist, int32_t* scratch_a, int32_t* scratch_b,
                             uint8_t* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n = (int64_t)a * b * c;
  edt_first_kernel<<<blocks(n), kThreads, 0, s>>>(occ, n, (int64_t)b * c, a, r, 0, scratch_a);
  edt_axis_kernel<<<blocks(n), kThreads, 0, s>>>(scratch_a, n, c, b, r, scratch_b);
  edt_texture_3d_kernel<<<blocks(n), kThreads, 0, s>>>(scratch_b, n, 1, c, r, res, max_dist,
                                                       out);
  return (int)cudaGetLastError();
}
