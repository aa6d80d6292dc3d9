// In-kernel primitive probes for Hopper (sm_90a).
//
// Replace the five Pallas probes of raytracinggpu_tpu/bench/micro_kernel.py,
// which priced the TPU's building blocks before its fused cast kernel was
// designed.  Each probe here asks Hopper the question the TPU probe asked
// the TPU; the contract (inputs, outputs, the per-ray min, 1e9 on a miss)
// is kept, the mechanism (VMEM scratch, scalar prefetch, the (128, 128)
// running-min tile, int8 lists) is not:
//   B7a rt_probe_tile_slope     (bench_tile_slope): what one (subgroup,
//       tile) visit costs, and a cast with none;
//   B7b rt_probe_block_mask     (bench_dma_smem) and its control
//       rt_probe_block_mask_control: what it costs a block to compute a
//       small mask with its threads, publish it through shared memory and
//       bound a loop with scalars read back from it;
//   B7c rt_probe_uniform_branch (bench_scalar_branch): what a visit
//       skipped under a warp-uniform predicate costs;
//   B7d rt_probe_row_gather     (bench_inkernel_gather): the rate of a
//       data-dependent gather of 512-byte rows;
//   B7e rt_probe_pair_slope     (bench_pair_slope): what a (subgroup,
//       tile) pair costs when a 1024-ray block walks one flat pair list,
//       at subgroups of 8 to 64 rays.
//
// Shared inputs of B7a, B7c, B7e:
//   rf  (R, 16) f32 row-major ray features [u, w = O x u, O, ...]; columns
//       0-8 are read;
//   tri (16, Tp) f32, Tp = n_tiles * 128 triangles; the field rows of
//       mt.cuh (0-2 Ng, 3-5 e2 x A, 6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng);
//   t   (R,) f32: per ray the min of the Moller-Trumbore pass over every
//       visited tile's 128 triangles, 1e9 where nothing was hit.
// The pass is mt.cuh's test with eps = 1e-4.  The JAX probe's _mt_pass has
// no denom != 0 term, and needs none: with denom = 0 the reciprocal is
// +-inf, so beta and gamma are +-inf or NaN, and when both are +inf alpha
// is -inf, so min(beta, gamma, alpha) >= 0 already fails.
//
// Numerics: a min of f32 values is exact in any order, so with
// --fmad=false every probe equals its plain version in
// bench/micro_kernel.py bit for bit whatever its thread mapping.
//
// What bounds them on this card: B7a, B7c and B7e are operations-bound
// (39 f32 operations and 16 field loads a test, the cat-sized table in
// L1/L2); B7b and B7d are bytes-bound (each byte read once and written
// once).  The designs are the simple ones: B7a and B7c one thread per ray
// with the running min in a register (as B5); B7b one 256-thread block per
// 1024 rays moving 16 bytes a thread; B7d one warp per row, 16 bytes a
// lane; B7e one 1024-thread block per 1024 rays whose threads share out
// the flat list's (pair, ray) items and combine through an atomicMin on
// the bit pattern in shared memory (exact: every value is positive).

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr int kNF = 16;        // features per ray row, field rows per triangle
constexpr int kTile = 128;     // triangles per tile
constexpr int kBlk = 1024;     // rays per block of B7b and B7e
constexpr float kEps = 1e-4f;  // _mt_pass keeps t > 1e-4
constexpr int kThreads = 128;

__device__ __forceinline__ Ray load_ray_row(const float* __restrict__ rf,
                                            int r) {
  const float* p = rf + static_cast<size_t>(r) * kNF;
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
}

// min(best, the pass of ray q over tile `tile`'s 128 triangles)
__device__ __forceinline__ float tile_pass(const Ray& q,
                                           const float* __restrict__ tri,
                                           int Tp, int tile, float best) {
  const float* f = tri + tile * kTile;
  for (int k = 0; k < kTile; ++k, ++f) {
    const MTHit h = mt_test(q, f, Tp, kEps);
    if (h.valid && h.t < best) best = h.t;
  }
  return best;
}

// B7a.  lists (R / subg, Lw) i32 rows [count, tile ids...]; ids outside
// [0, n_tiles) are skipped and count is cut at Lw - 1.
__global__ void __launch_bounds__(kThreads)
tile_slope_kernel(const int* __restrict__ lists, const float* __restrict__ rf,
                  const float* __restrict__ tri, int R, int Tp, int Lw,
                  int subg, float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Ray q = load_ray_row(rf, r);
  const int n_tiles = Tp / kTile;
  const int* row = lists + static_cast<size_t>(r / subg) * Lw;
  const int count = min(row[0], Lw - 1);
  float best = kInf;
  for (int i = 0; i < count; ++i) {
    const int tile = row[1 + i];
    if (tile < 0 || tile >= n_tiles) continue;
    best = tile_pass(q, tri, Tp, tile, best);
  }
  t_out[r] = best;
}

// B7c.  mask (R / subg, Mw) i32; tile j < n_fixed is visited iff
// mask[sg, j] > 0.  With subg >= 32 the predicate is warp-uniform.
__global__ void __launch_bounds__(kThreads)
uniform_branch_kernel(const int* __restrict__ mask,
                      const float* __restrict__ rf,
                      const float* __restrict__ tri, int R, int Tp, int Mw,
                      int subg, int n_fixed, float* __restrict__ t_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Ray q = load_ray_row(rf, r);
  const int* row = mask + static_cast<size_t>(r / subg) * Mw;
  float best = kInf;
  for (int j = 0; j < n_fixed; ++j) {
    if (row[j] > 0) best = tile_pass(q, tri, Tp, j, best);
  }
  t_out[r] = best;
}

// B7b.  One block per 1024 rows of x (R, 16).  With kMask the block's
// threads compute the (32, 16) mask x[0:32, 0:16] > 0.5 of its first rows
// into shared memory; after the barrier every thread reads two of its
// words as scalars (a broadcast) and runs a loop they bound; the loop's
// body is an empty volatile statement, so neither the loop nor the mask
// can be dropped, and out = 2 x either way.
template <bool kMask>
__global__ void __launch_bounds__(256)
block_mask_kernel(const float* __restrict__ x, float* __restrict__ out) {
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlk * kNF;
  if constexpr (kMask) {
    __shared__ int m[32 * kNF];
    for (int i = threadIdx.x; i < 32 * kNF; i += blockDim.x)
      m[i] = x[base + i] > 0.5f ? 1 : 0;
    __syncthreads();
    const int n = m[0] + m[kNF + 1];  // mask[0, 0] + mask[1, 1]
    for (int i = 0; i < n; ++i) asm volatile("" ::"r"(i));
  }
  const float4* src = reinterpret_cast<const float4*>(x + base);
  float4* dst = reinterpret_cast<float4*>(out + base);
  for (int i = threadIdx.x; i < kBlk * kNF / 4; i += blockDim.x) {
    float4 v = src[i];
    v.x *= 2.0f;
    v.y *= 2.0f;
    v.z *= 2.0f;
    v.w *= 2.0f;
    dst[i] = v;
  }
}

// B7d.  out[i, :] = table[idx[i], :], rows of 128 f32; one warp a row, 16
// bytes a lane.  An index outside [0, n_rows) is clamped, so that nothing
// outside the table is read.
__global__ void __launch_bounds__(256)
row_gather_kernel(const int* __restrict__ idx, const float* __restrict__ table,
                  int R, int n_rows, float* __restrict__ out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= R) return;
  const int src = min(max(idx[row], 0), n_rows - 1);
  const float4* s =
      reinterpret_cast<const float4*>(table + static_cast<size_t>(src) * kTile);
  float4* d =
      reinterpret_cast<float4*>(out + static_cast<size_t>(row) * kTile);
  d[lane] = s[lane];
}

// B7e.  pairs (R / 1024, Pw) i32 rows [count, sg * 256 + tile, ...]: one
// flat list a 1024-ray block; pair (sg, tile) sends rays sg * subg ..
// sg * subg + subg - 1 of the block over tile `tile`.  The block's 1024
// threads share out the list's count * subg (pair, ray) items, so every
// lane works whatever the subgroup size (below 32 a warp holds several
// pairs and reads several tiles at once); a ray's running min lives in
// shared memory as the bit pattern of a positive f32, where an integer
// atomicMin is the float min.  Pairs naming a subgroup or tile outside the
// block or the table are skipped; count is cut at Pw - 1.
__global__ void __launch_bounds__(kBlk)
pair_slope_kernel(const int* __restrict__ pairs, const float* __restrict__ rf,
                  const float* __restrict__ tri, int Tp, int Pw, int subg,
                  float* __restrict__ t_out) {
  __shared__ int t_run[kBlk];
  const int r0 = blockIdx.x * kBlk;
  t_run[threadIdx.x] = __float_as_int(kInf);
  __syncthreads();
  const int* row = pairs + static_cast<size_t>(blockIdx.x) * Pw;
  const int count = min(row[0], Pw - 1);
  const int n_tiles = Tp / kTile;
  const int n_sg = kBlk / subg;
  const int items = count * subg;
  for (int it = threadIdx.x; it < items; it += kBlk) {
    const int p = row[1 + it / subg];
    const int sg = p >> 8;
    const int tile = p & 255;
    if (p < 0 || sg >= n_sg || tile >= n_tiles) continue;
    const int lr = sg * subg + it % subg;
    const Ray q = load_ray_row(rf, r0 + lr);
    const float t = tile_pass(q, tri, Tp, tile, kInf);
    if (t < kInf) atomicMin(&t_run[lr], __float_as_int(t));
  }
  __syncthreads();
  t_out[r0 + threadIdx.x] = __int_as_float(t_run[threadIdx.x]);
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

int rt_probe_tile_slope(const int* lists, const float* rf, const float* tri,
                        int R, int Tp, int Lw, int subg, float* t_out,
                        void* stream) {
  tile_slope_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      lists, rf, tri, R, Tp, Lw, subg, t_out);
  return last_error();
}

int rt_probe_uniform_branch(const int* mask, const float* rf,
                            const float* tri, int R, int Tp, int Mw, int subg,
                            int n_fixed, float* t_out, void* stream) {
  uniform_branch_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      mask, rf, tri, R, Tp, Mw, subg, n_fixed, t_out);
  return last_error();
}

// R must be a multiple of 1024 (the wrapper checks).
int rt_probe_block_mask(const float* x, int R, float* out, void* stream) {
  block_mask_kernel<true>
      <<<R / kBlk, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return last_error();
}

int rt_probe_block_mask_control(const float* x, int R, float* out,
                                void* stream) {
  block_mask_kernel<false>
      <<<R / kBlk, 256, 0, static_cast<cudaStream_t>(stream)>>>(x, out);
  return last_error();
}

int rt_probe_row_gather(const int* idx, const float* table, int R, int n_rows,
                        float* out, void* stream) {
  const int rows_per_block = 256 / 32;
  row_gather_kernel<<<(R + rows_per_block - 1) / rows_per_block, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(idx, table, R,
                                                           n_rows, out);
  return last_error();
}

// R must be a multiple of 1024 and subg divide 1024 (the wrapper checks).
int rt_probe_pair_slope(const int* pairs, const float* rf, const float* tri,
                        int R, int Tp, int Pw, int subg, float* t_out,
                        void* stream) {
  pair_slope_kernel<<<R / kBlk, kBlk, 0, static_cast<cudaStream_t>(stream)>>>(
      pairs, rf, tri, Tp, Pw, subg, t_out);
  return last_error();
}

}  // extern "C"
