// Connected-component labels of the occupied pose-histogram bins, the
// fixpoint of the JAX package's min-label dilation in three launches.
//
// Replaces badger_amcl_tpu/pf/cluster.py:72, the `lax.while_loop` of
// `_cluster_grid` (no Pallas kernel: XLA runs its box-min sweeps on the
// device until no label changes). Eager PyTorch reads a change flag back
// to the host after every few sweeps, and a captured CUDA graph cannot
// loop on a device value without a WHILE node; this kernel computes the
// fixpoint itself, with no host read and no loop on the host.
//
// The fixpoint labels every occupied cell with the smallest flat index of
// its component (26-neighbourhood, the 3x3x3 box of the sweeps; the grid's
// empty border keeps the sweeps' roll wrap-around out, so no wrap here),
// and every empty cell with BIG. A component's minimum is unique, so any
// schedule that reaches it gives the sweeps' labels bit for bit. Here it
// is reached by union-find (Playne and Hawick's lock-free union with
// atomicMin, with path halving): every parent index is <= its cell's, so a
// tree's root is its smallest cell; each occupied cell unites with its 13
// forward occupied neighbours (each unordered pair once); a last pass
// points every occupied cell at its root. The sweeps' cost grows with a
// component's diameter (one cell per sweep); this does not.
//
// Grids are batched: `total` = batch * n cells, n = ga * gx * gy in (a, x, y)
// packing, and a label is the flat index within its own grid.
//
// Bound: the bytes the function must move are the occupancy read and the
// labels written, 5 bytes a cell (3.3 MB on the 128 x 128 x 40 histogram,
// ~1 us at 3.35 TB/s); the parent array adds 8 bytes a cell (written,
// then read), L2-resident at these sizes. Each launch is one thread a
// cell; at the slice's grid sizes the three launches' fixed cost dominates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int32_t kBig = 1 << 30;  // kld.BIG: an empty cell's label

int blocks(int64_t n) { return (int)((n + kThreads - 1) / kThreads); }

// The root of x's tree, halving the path on the way (each visited cell
// skips to its grandparent, by atomicMin: a parent only ever moves to a
// smaller cell of the same tree, so concurrent unions keep their links and
// the trees stay shallow). Parents are read through L2 (__ldcg): other SMs
// move them with atomics.
__device__ __forceinline__ int32_t find_root(int32_t* parent, int32_t x) {
  int32_t p = __ldcg(parent + x);
  while (p != x) {
    const int32_t gp = __ldcg(parent + p);
    if (gp < p) atomicMin(parent + x, gp);
    x = gp;
    p = __ldcg(parent + x);
  }
  return x;
}

// Join the trees of a and b: the larger root is hung under the smaller one
// by atomicMin, retried from wherever a concurrent union moved it.
__device__ void unite(int32_t* parent, int32_t a, int32_t b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int32_t t = a;
      a = b;
      b = t;
    }
    const int32_t old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void init_kernel(int32_t total, int32_t* __restrict__ parent) {
  const int32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g < total) parent[g] = g;
}

__global__ void unite_kernel(const bool* __restrict__ occ, int32_t total, int gx, int gy,
                             int ga, int32_t* parent) {
  const int32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total || !occ[g]) return;
  const int32_t plane = gx * gy;
  const int32_t i = g % (plane * ga);
  const int a = i / plane;
  const int x = (i - a * plane) / gy;
  const int y = i - a * plane - x * gy;
  // the 13 neighbours whose flat offset (da * gx + dx) * gy + dy is positive
  for (int da = 0; da <= 1; ++da) {
    if (a + da >= ga) break;
    for (int dx = -1; dx <= 1; ++dx) {
      if (da == 0 && dx < 0) continue;
      if (x + dx < 0 || x + dx >= gx) continue;
      for (int dy = -1; dy <= 1; ++dy) {
        if (da == 0 && dx == 0 && dy <= 0) continue;
        if (y + dy < 0 || y + dy >= gy) continue;
        const int32_t nb = g + (da * gx + dx) * gy + dy;
        if (occ[nb]) unite(parent, g, nb);
      }
    }
  }
}

__global__ void label_kernel(const bool* __restrict__ occ, int32_t total, int32_t n,
                             int32_t* parent, int32_t* __restrict__ labels) {
  const int32_t g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  labels[g] = occ[g] ? find_root(parent, g) - (g / n) * n : kBig;
}

}  // namespace

// occ: bool (batch, ga, gx, gy) contiguous, total = batch * ga * gx * gy
// < 2^31 cells; parent: int32 scratch of total; labels: int32 out of total.
extern "C" int cluster_labels_launch(const bool* occ, int total, int gx, int gy, int ga,
                                     int32_t* parent, int32_t* labels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (total <= 0) return (int)cudaGetLastError();
  init_kernel<<<blocks(total), kThreads, 0, s>>>(total, parent);
  unite_kernel<<<blocks(total), kThreads, 0, s>>>(occ, total, gx, gy, ga, parent);
  label_kernel<<<blocks(total), kThreads, 0, s>>>(occ, total, ga * gx * gy, parent, labels);
  return (int)cudaGetLastError();
}
