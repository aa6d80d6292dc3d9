// Tiled-kernel traversal kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernels of raytracinggpu_tpu/ops/pallas_trace.py:
//   B5  rt_pallas_closest: _closest_hit_kernel (via _closest_hit_call),
//       closest hit, t and triangle index;
//   B6  rt_pallas_shadow:  _shadow_kernel (via _shadow_call), nearest t.
//
// Contract (the JAX kernels', not their mechanism):
//   rfT    (16, R) f32 ray-feature rows [u, w = O x u, O, 1/u, pad]; rows
//          0-8 are read;
//   fields (16, Tp) f32, Tp = n_tiles * tile_t triangles in BVH order;
//          rows 0-2 Ng, 3-5 e2 x A, 6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng;
//   lists  (R / subg, L) i32, one row per subgroup of subg consecutive
//          rays: [count, tile ids...]; the first count ids (at most L - 1)
//          name the tiles the subgroup's rays test; ids outside
//          [0, n_tiles) are skipped.
//   A ray runs the Moller-Trumbore test of mt.cuh on every triangle of
//   every listed tile.  B5 keeps the lexicographic min of (t, index): the
//   nearest t, the lowest index on exact ties, as the JAX kernel's
//   strict-< running min over ascending tiles and its lowest-lane argmin
//   epilogue give it; a ray whose min is not below INF (1e9 in f32) gets
//   t = INF and index 0.  B6 keeps min(INF, t).
//
// Design: one thread per ray, 128-thread blocks.  The Pallas program's
// 1024-ray grid step, its (128, 128) VMEM running-min scratch and its
// lane-axis argmin epilogue are TPU layout; here the running min lives in
// registers.  With subg >= 32 every warp lies inside one subgroup, so the
// walk over the list is warp-uniform and every field load is a broadcast;
// the cat's table (4096 x 16 x 4 B = 262 KB) stays in L1/L2.
//
// What bounds it on this card: each (ray, triangle) test costs 16 field
// loads and about 40 f32 operations with no reuse across rays in
// registers, so it is issue-bound on the arithmetic and loads; the work is
// the number of (subgroup, listed tile) visits times 128 triangles times
// the subgroup width.  Shared-memory staging of the tiles, cp.async/TMA
// prefetch and work lists are later work.
//
// Numerics (mt.cuh): with --fmad=false and IEEE division the kernels
// equal the plain versions in ops/pallas_trace.py bit for bit.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kIdxBig = 1 << 30;      // index no triangle has
constexpr int kThreads = 128;

// Template modes; ptxas names the kernels pallas_kernel<false/true>
// (ILb0E, ILb1E).
template <bool kClosest>
__global__ void __launch_bounds__(kThreads)
pallas_kernel(const float* __restrict__ rfT, const float* __restrict__ fields,
              const int* __restrict__ lists, int R, int Tp, int L, int subg,
              int tile_t, float eps, float* __restrict__ t_out,
              int* __restrict__ idx_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Ray q = load_ray(rfT, R, r);
  const int n_tiles = Tp / tile_t;
  const int* row = lists + (r / subg) * L;
  const int count = min(row[0], L - 1);

  float best_t = kInf;
  int best_i = kIdxBig;
  for (int i = 0; i < count; ++i) {
    const int tile = row[1 + i];
    if (tile < 0 || tile >= n_tiles) continue;
    const int base = tile * tile_t;
    const float* f = fields + base;
    for (int k = 0; k < tile_t; ++k, ++f) {
      const MTHit h = mt_test(q, f, Tp, eps);
      if (!h.valid) continue;
      if constexpr (kClosest) {
        const int id = base + k;
        if (h.t < best_t || (h.t == best_t && id < best_i)) {
          best_t = h.t;
          best_i = id;
        }
      } else {
        if (h.t < best_t) best_t = h.t;
      }
    }
  }
  t_out[r] = best_t;
  if constexpr (kClosest) idx_out[r] = best_t < kInf ? best_i : 0;
}

template <bool kClosest>
int launch(const float* rfT, const float* fields, const int* lists, int R,
           int Tp, int L, int subg, int tile_t, float eps, float* t_out,
           int* idx_out, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  pallas_kernel<kClosest>
      <<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          rfT, fields, lists, R, Tp, L, subg, tile_t, eps, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_pallas_shadow(const float* rfT, const float* fields, const int* lists,
                     int R, int Tp, int L, int subg, int tile_t, float eps,
                     float* t_out, void* stream) {
  return launch<false>(rfT, fields, lists, R, Tp, L, subg, tile_t, eps, t_out,
                       nullptr, stream);
}

int rt_pallas_closest(const float* rfT, const float* fields, const int* lists,
                      int R, int Tp, int L, int subg, int tile_t, float eps,
                      float* t_out, int* idx_out, void* stream) {
  return launch<true>(rfT, fields, lists, R, Tp, L, subg, tile_t, eps, t_out,
                      idx_out, stream);
}

}  // extern "C"
