// Distance-field lookups at the (beam, particle) scan endpoints.
//
// Replaces the Pallas TPU kernel badger_amcl_tpu/ops/lf_kernel.py `_kernel`
// (via `windowed_distance_gather` / `lf_distances_t`), the XLA
// reductions of its prepass `window_origins` and the XLA passes over its
// (B, M) output that beam skipping takes (badger_amcl_tpu/sensors/
// planar.py `_lf_prob_model`):
//
//   th = pth[m] + a[b];  hx = px[m] + r[b] cos(th);  hy = py[m] + r[b] sin(th)
//   ci = floor((hx - ox) / res + 0.5) + half_x   (world_to_map,
//   cj = floor((hy - oy) / res + 0.5) + half_y    occupancy_map.cpp:90-98)
//   z[b, m] = tex[cj, ci] if (ci, cj) is on the map else max_dist
//
// templated over the texture type: the bf16 texture reproduces the TPU
// kernel's contract (its one-hot MXU pick returns the bf16 cell value
// exactly), the f32 texture the exact gather the JAX package takes when
// the per-beam window does not fit. Multiplies, adds and the division are
// rounded separately and cos/sin are the full-precision ones (sincosf, the
// values of cosf and sinf; no fast math), per element as in the JAX
// kernel, matching the plain PyTorch version. Four entry points share that
// endpoint function:
//
// - lf_distances_{f32,bf16}_launch: z itself, (B, M) f32, one thread per
//   (b, m), m fastest, so the stores coalesce: the counterpart of the JAX
//   package's `lf_distances_t`, which no main path of the port launches
//   (beam skipping takes lf_obs_counts and lf_term_sums). Bound: the 144
//   MB (720 x 50k) output write, ~43 us at 3.35 TB/s;
// - lf_term_sums_{f32,bf16}_launch: s[m] = sum over valid b of term(z),
//   (M,) f32, term one of sensors.planar's BeamTerm forms
//   pz^3 / pz / log pz with pz = z_hit exp(-(z z) / denom) + zr, computed
//   with the plain expression's roundings (IEEE division by denom,
//   full-precision expf/logf), summed in double and rounded once. A block
//   is 32 particles x kGroups warps; warp g sums the beams b = g (mod
//   kGroups) and the warps' sums are added in group order. Nothing (B, M)
//   is written. Bound: ~21 operations per (particle, valid beam), the
//   endpoint's cos and sin counted as one each;
// - lf_extents_launch: the per-beam extents of the in-map endpoint cells,
//   (4, B) int32 rows ci_min, ci_max, cj_min, cj_max, +-2^30 for a beam
//   with no in-map endpoint. One block row per beam, each thread reduces
//   its particles, then a warp reduction and one atomic per warp, beam and
//   extent. The wrapper finishes the TPU kernel's window alignment and
//   fits test on the (B,) results;
// - lf_obs_counts_{f32,bf16}_launch: beam skipping's first pass
//   (planar_scanner.cpp:441-453), (B,) int32 counts per valid beam of the
//   active particles whose endpoint cell is on the map and reads a value
//   below the skip distance. The extents' layout: one block row per beam
//   (an invalid beam's block returns before forming an endpoint, whose
//   range may be NaN), several particles per thread, a warp sum
//   (__reduce_add_sync) and one atomicAdd per warp and beam into the
//   zeroed output. Bound: ~16 operations per (active particle, valid
//   beam), as the extents'.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroups = 4;
constexpr int kBeamChunk = 1024;
constexpr int kBig = 1 << 30;
constexpr int kExtentThreads = 256;
constexpr int kExtentPerThread = 8;
// term forms (sensors.planar BeamTerm / ops.spread_kernel.TERM_FORMS)
constexpr int kCube = 0;
constexpr int kPz = 1;
constexpr int kLog = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Geom {
  float res, ox, oy;
  int half_x, half_y, size_x, size_y;
  float max_dist;
};

// the endpoint cell of particle (x, y, yaw) through beam (r, a)
__device__ __forceinline__ void endpoint_cell(float x, float y, float yaw, float r, float a,
                                              const Geom& g, int& ci, int& cj) {
  float s, c;
  sincosf(__fadd_rn(yaw, a), &s, &c);  // the values of sinf and cosf
  const float hx = __fadd_rn(x, __fmul_rn(r, c));
  const float hy = __fadd_rn(y, __fmul_rn(r, s));
  ci = (int)floorf(__fadd_rn(__fdiv_rn(__fsub_rn(hx, g.ox), g.res), 0.5f)) + g.half_x;
  cj = (int)floorf(__fadd_rn(__fdiv_rn(__fsub_rn(hy, g.oy), g.res), 0.5f)) + g.half_y;
}

__device__ __forceinline__ bool on_map(int ci, int cj, const Geom& g) {
  return ci >= 0 && ci < g.size_x && cj >= 0 && cj < g.size_y;
}

template <typename T>
__device__ __forceinline__ float endpoint_value(const T* __restrict__ tex, float x, float y,
                                                float yaw, float r, float a, const Geom& g) {
  int ci, cj;
  endpoint_cell(x, y, yaw, r, a, g, ci, cj);
  return on_map(ci, cj, g) ? to_float(tex[(int64_t)cj * g.size_x + ci]) : g.max_dist;
}

template <typename T>
__global__ void lf_distances_kernel(const T* __restrict__ tex, const float* __restrict__ spose,
                                    int m, const float* __restrict__ ranges,
                                    const float* __restrict__ angles, int n_beams, Geom g,
                                    float* __restrict__ out) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)m * n_beams) return;
  const int b = (int)(i / m);
  const int p = (int)(i - (int64_t)b * m);
  out[i] = endpoint_value(tex, spose[3 * p], spose[3 * p + 1], spose[3 * p + 2], ranges[b],
                          angles[b], g);
}

template <int kForm>
__device__ __forceinline__ float beam_term(float z, float z_hit, float denom, float zr) {
  const float e = expf(__fdiv_rn(-__fmul_rn(z, z), denom));
  const float pz = __fadd_rn(__fmul_rn(z_hit, e), zr);
  if (kForm == kCube) return __fmul_rn(__fmul_rn(pz, pz), pz);
  if (kForm == kPz) return pz;
  return logf(pz);
}

template <typename T, int kForm>
__global__ void __launch_bounds__(32 * kGroups) lf_term_sums_kernel(
    const T* __restrict__ tex, const float* __restrict__ spose, int m,
    const float* __restrict__ ranges, const float* __restrict__ angles,
    const bool* __restrict__ valid, int n_beams, Geom g,
    float z_hit, float denom, float zr, float* __restrict__ out) {
  __shared__ float s_r[kBeamChunk];
  __shared__ float s_a[kBeamChunk];
  __shared__ bool s_valid[kBeamChunk];
  __shared__ double s_part[kGroups][32];
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int grp = threadIdx.y;
  const int i = blockIdx.x * 32 + threadIdx.x;
  const bool live = i < m;
  const float x = live ? spose[3 * i] : 0.0f;
  const float y = live ? spose[3 * i + 1] : 0.0f;
  const float yaw = live ? spose[3 * i + 2] : 0.0f;
  double acc = 0.0;
  for (int base = 0; base < n_beams; base += kBeamChunk) {
    const int n = min(kBeamChunk, n_beams - base);
    __syncthreads();
    for (int k = tid; k < n; k += 32 * kGroups) {
      s_r[k] = ranges[base + k];
      s_a[k] = angles[base + k];
      s_valid[k] = valid[base + k];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = grp; k < n; k += kGroups) {
      if (!s_valid[k]) continue;
      const float z = endpoint_value(tex, x, y, yaw, s_r[k], s_a[k], g);
      acc += (double)beam_term<kForm>(z, z_hit, denom, zr);
    }
  }
  s_part[grp][threadIdx.x] = acc;
  __syncthreads();
  if (grp == 0 && live) {
    double sum = s_part[0][threadIdx.x];
#pragma unroll
    for (int j = 1; j < kGroups; ++j) sum += s_part[j][threadIdx.x];
    out[i] = (float)sum;
  }
}

__global__ void lf_extents_init_kernel(int32_t* __restrict__ ext, int n_beams) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 4 * n_beams) ext[i] = (i / n_beams) % 2 == 0 ? kBig : -kBig;
}

__global__ void __launch_bounds__(kExtentThreads) lf_extents_kernel(
    const float* __restrict__ spose, int m, const float* __restrict__ ranges,
    const float* __restrict__ angles, int n_beams, Geom g, int32_t* __restrict__ ext) {
  const int b = blockIdx.y;
  const float r = ranges[b];
  const float a = angles[b];
  int lo_i = kBig, hi_i = -kBig, lo_j = kBig, hi_j = -kBig;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < m; p += gridDim.x * blockDim.x) {
    int ci, cj;
    endpoint_cell(spose[3 * p], spose[3 * p + 1], spose[3 * p + 2], r, a, g, ci, cj);
    if (on_map(ci, cj, g)) {
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
  if ((threadIdx.x & 31) == 0 && lo_i != kBig) {
    atomicMin(ext + b, lo_i);
    atomicMax(ext + n_beams + b, hi_i);
    atomicMin(ext + 2 * n_beams + b, lo_j);
    atomicMax(ext + 3 * n_beams + b, hi_j);
  }
}

template <typename T>
__global__ void __launch_bounds__(kExtentThreads) lf_obs_counts_kernel(
    const T* __restrict__ tex, const float* __restrict__ spose, int m,
    const float* __restrict__ ranges, const float* __restrict__ angles,
    const bool* __restrict__ valid, const bool* __restrict__ active, Geom g, float skip,
    int32_t* __restrict__ counts) {
  const int b = blockIdx.y;
  if (!valid[b]) return;  // the whole block: its endpoints are never formed
  const float r = ranges[b];
  const float a = angles[b];
  int n = 0;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < m; p += gridDim.x * blockDim.x) {
    if (!active[p]) continue;
    int ci, cj;
    endpoint_cell(spose[3 * p], spose[3 * p + 1], spose[3 * p + 2], r, a, g, ci, cj);
    if (on_map(ci, cj, g) && to_float(tex[(int64_t)cj * g.size_x + ci]) < skip) ++n;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((threadIdx.x & 31) == 0 && n > 0) atomicAdd(counts + b, n);
}

Geom geom(float res, float ox, float oy, int half_x, int half_y, int size_x, int size_y,
          float max_dist) {
  return Geom{res, ox, oy, half_x, half_y, size_x, size_y, max_dist};
}

template <typename T>
int launch_distances(const T* tex, const float* spose, int m, const float* ranges,
                     const float* angles, int n_beams, Geom g, float* out, void* stream) {
  const int threads = 256;
  const int64_t n = (int64_t)m * n_beams;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  lf_distances_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      tex, spose, m, ranges, angles, n_beams, g, out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_term_sums(const T* tex, const float* spose, int m, const float* ranges,
                     const float* angles, const bool* valid, int n_beams, Geom g, int form,
                     float z_hit, float denom, float zr, float* out, void* stream) {
  const dim3 grid((m + 31) / 32);
  const dim3 block(32, kGroups);
  cudaStream_t s = (cudaStream_t)stream;
#define LF_TERM_ARGS tex, spose, m, ranges, angles, valid, n_beams, g, z_hit, denom, zr, out
  if (form == kCube) {
    lf_term_sums_kernel<T, kCube><<<grid, block, 0, s>>>(LF_TERM_ARGS);
  } else if (form == kPz) {
    lf_term_sums_kernel<T, kPz><<<grid, block, 0, s>>>(LF_TERM_ARGS);
  } else if (form == kLog) {
    lf_term_sums_kernel<T, kLog><<<grid, block, 0, s>>>(LF_TERM_ARGS);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LF_TERM_ARGS
  return (int)cudaGetLastError();
}

template <typename T>
int launch_obs_counts(const T* tex, const float* spose, int m, const float* ranges,
                      const float* angles, const bool* valid, const bool* active, int n_beams,
                      Geom g, float skip, int32_t* counts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaMemsetAsync(counts, 0, sizeof(int32_t) * n_beams, s);
  const int per_block = kExtentThreads * kExtentPerThread;
  const dim3 grid((m + per_block - 1) / per_block, n_beams);
  if (m > 0 && n_beams > 0) {
    lf_obs_counts_kernel<T><<<grid, kExtentThreads, 0, s>>>(tex, spose, m, ranges, angles,
                                                           valid, active, g, skip, counts);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lf_distances_f32_launch(const float* tex, const float* spose, int m,
                                       const float* ranges, const float* angles, int n_beams,
                                       float res, float ox, float oy, int half_x, int half_y,
                                       int size_x, int size_y, float max_dist, float* out,
                                       void* stream) {
  return launch_distances<float>(tex, spose, m, ranges, angles, n_beams,
                                 geom(res, ox, oy, half_x, half_y, size_x, size_y, max_dist),
                                 out, stream);
}

extern "C" int lf_distances_bf16_launch(const void* tex, const float* spose, int m,
                                        const float* ranges, const float* angles,
                                        int n_beams, float res, float ox, float oy,
                                        int half_x, int half_y, int size_x, int size_y,
                                        float max_dist,
                                        float* out, void* stream) {
  return launch_distances<__nv_bfloat16>(
      (const __nv_bfloat16*)tex, spose, m, ranges, angles, n_beams,
      geom(res, ox, oy, half_x, half_y, size_x, size_y, max_dist), out, stream);
}

extern "C" int lf_term_sums_f32_launch(const float* tex, const float* spose, int m,
                                       const float* ranges, const float* angles,
                                       const bool* valid, int n_beams,
                                       float res, float ox, float oy, int half_x, int half_y,
                                       int size_x, int size_y, float max_dist, int form,
                                       float z_hit, float denom, float zr, float* out,
                                       void* stream) {
  return launch_term_sums<float>(tex, spose, m, ranges, angles, valid, n_beams,
                                 geom(res, ox, oy, half_x, half_y, size_x, size_y, max_dist),
                                 form, z_hit, denom, zr, out, stream);
}

extern "C" int lf_term_sums_bf16_launch(const void* tex, const float* spose, int m,
                                        const float* ranges, const float* angles,
                                        const bool* valid, int n_beams,
                                        float res, float ox, float oy, int half_x,
                                        int half_y, int size_x, int size_y, float max_dist,
                                        int form, float z_hit, float denom, float zr,
                                        float* out, void* stream) {
  return launch_term_sums<__nv_bfloat16>(
      (const __nv_bfloat16*)tex, spose, m, ranges, angles, valid, n_beams,
      geom(res, ox, oy, half_x, half_y, size_x, size_y, max_dist), form, z_hit, denom, zr,
      out, stream);
}

extern "C" int lf_extents_launch(const float* spose, int m, const float* ranges,
                                 const float* angles, int n_beams,
                                 float res, float ox, float oy, int half_x, int half_y,
                                 int size_x, int size_y, int32_t* ext, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  lf_extents_init_kernel<<<(4 * n_beams + 255) / 256, 256, 0, s>>>(ext, n_beams);
  const int per_block = kExtentThreads * kExtentPerThread;
  const dim3 grid((m + per_block - 1) / per_block, n_beams);
  if (m > 0) {
    lf_extents_kernel<<<grid, kExtentThreads, 0, s>>>(
        spose, m, ranges, angles, n_beams,
        geom(res, ox, oy, half_x, half_y, size_x, size_y, 0.0f), ext);
  }
  return (int)cudaGetLastError();
}

extern "C" int lf_obs_counts_f32_launch(const float* tex, const float* spose, int m,
                                        const float* ranges, const float* angles,
                                        const bool* valid, const bool* active, int n_beams,
                                        float res, float ox, float oy, int half_x, int half_y,
                                        int size_x, int size_y, float skip, int32_t* counts,
                                        void* stream) {
  return launch_obs_counts<float>(tex, spose, m, ranges, angles, valid, active, n_beams,
                                  geom(res, ox, oy, half_x, half_y, size_x, size_y, 0.0f),
                                  skip, counts, stream);
}

extern "C" int lf_obs_counts_bf16_launch(const void* tex, const float* spose, int m,
                                         const float* ranges, const float* angles,
                                         const bool* valid, const bool* active, int n_beams,
                                         float res, float ox, float oy, int half_x,
                                         int half_y, int size_x, int size_y, float skip,
                                         int32_t* counts, void* stream) {
  return launch_obs_counts<__nv_bfloat16>(
      (const __nv_bfloat16*)tex, spose, m, ranges, angles, valid, active, n_beams,
      geom(res, ox, oy, half_x, half_y, size_x, size_y, 0.0f), skip, counts, stream);
}
