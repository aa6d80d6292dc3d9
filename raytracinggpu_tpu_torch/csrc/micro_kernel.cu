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
// (39 f32 operations a test, the cat-sized table in L1/L2); B7b and B7d
// are bytes-bound (each byte read once and written once).  B7a, B7c and
// B7e price a visit under the staged design of the trace kernels
// (pairs_trace.cu, pallas_trace.cu): each warp walks a tile sequence that
// is the same for its 32 lanes, stages each tile 32 slots at a time
// through stage.cuh (slot-major, cp.async, a double buffer a warp, the
// next piece issued before the current one is tested) and reads a slot as
// four broadcast 16-byte shared loads over a compile-time slot loop;
// padding slots (Ng = 0) are skipped as there.  B7a and B7c are one
// template, visit_kernel<kMasked>: one thread a ray in 128-thread blocks,
// subgroups of a whole number of warps, so that a warp's walk is its
// subgroup's (B7a: the listed ids; B7c: the fixed tiles whose mask word
// is set, the skip a scalar branch before any copy) and its running min
// stays in a register.  B7b: one 512-thread block per 1024 rows, eight
// 16-byte loads a thread ahead of its stores (a 256-thread block with a
// serial loop of 16 lost to torch.mul: at 131,072 rows it left 8 warps
// an SM; PERF.md, Findings, has the shapes measured).  B7d: one warp per
// row, 16 bytes a lane.  B7e: one 1024-thread block per 1024-ray list
// whose warps take the list's pairs in turn, one at a time, so that every
// warp's work is tile-uniform.  At subgroups of 32 rays and more a lane
// is a ray (a 64-ray pair is two warp items); below 32 a lane is a (ray,
// share of each piece's slots), and the 32 / subg lanes of one ray
// combine their mins by __shfl_xor_sync.  The warps merge through an
// atomicMin on the bit pattern in shared memory (exact: every value is
// positive).

#include <cuda_runtime.h>

#include "mt.cuh"
#include "stage.cuh"

namespace {

constexpr int kNF = 16;        // features per ray row, field rows per triangle
constexpr int kTile = 128;     // triangles per tile
constexpr int kBlk = 1024;     // rays per block of B7b and B7e
constexpr float kEps = 1e-4f;  // _mt_pass keeps t > 1e-4
constexpr int kPieces = kTile / kPiece;        // staged pieces a tile
constexpr int kBufFloats = kPiece * kStride;  // one staged piece

__device__ __forceinline__ Ray load_ray_row(const float* __restrict__ rf,
                                            int r) {
  const float* p = rf + static_cast<size_t>(r) * kNF;
  return {p[0], p[1], p[2], p[3], p[4], p[5], p[6], p[7], p[8]};
}

// B7a (kMasked false) and B7c (true).  rows (R / subg, W) i32, subg a
// multiple of 32 (the C entries refuse any other) that divides R:
// B7a's rows are [count, tile ids...], ids outside [0, n_tiles) skipped
// and count cut at W - 1; in B7c tile j < n_fixed is visited iff
// rows[sg, j] > 0.  A warp is 32 rays of one subgroup, so its walk (the
// lambda next) is warp-uniform; it stages each visited tile a piece at a
// time into its own double buffer and tests each piece while the next
// one (of this tile or of the next visited) is in flight.  The slot loop
// is unrolled 8 times: 1 to 2% faster than 4, 7% faster than 2; 256-thread
// blocks and a buffer shared by a subgroup's two warps lost (PERF.md).
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <bool kMasked>
__global__ void __launch_bounds__(kThreads)
visit_kernel(const int* __restrict__ rows, const float* __restrict__ rf,
             const float* __restrict__ tri, int R, int Tp, int W, int subg,
             int n_fixed, float* __restrict__ t_out) {
  __shared__ __align__(16) float smem[kWarps * 2 * kBufFloats];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kThreads + warp * 32;  // the warp's first ray
  if (r0 >= R) return;
  float* const buf = smem + warp * 2 * kBufFloats;
  const int* const row = rows + static_cast<size_t>(r0 / subg) * W;
  const int n_tiles = Tp / kTile;
  const int end = kMasked ? n_fixed : min(row[0], W - 1);

  int pos = -1, tile = 0, piece = kPieces;
  const auto next = [&]() {
    if (++piece < kPieces) return true;
    while (++pos < end) {
      if constexpr (kMasked) {
        if (row[pos] > 0) {  // the skip: one word read, nothing staged
          tile = pos;
          piece = 0;
          return true;
        }
      } else {
        tile = row[1 + pos];
        if (tile >= 0 && tile < n_tiles) {
          piece = 0;
          return true;
        }
      }
    }
    return false;
  };

  // lane l copies slot l of the piece: one coalesced row at a time
  const auto stage_piece = [&](float* dst) {
    const float* src = tri + tile * kTile + piece * kPiece + lane;
#pragma unroll
    for (int k = 0; k < kNF; ++k)
      cp_async4(dst + lane * kStride + k, src + k * Tp);
    cp_async_commit();
  };

  // the ray is read behind the first piece's copy, and not at all by a
  // warp that visits nothing
  Ray q{};
  float best = kInf;
  int b = 0;
  bool have = next();
  if (have) {
    stage_piece(buf);
    q = load_ray_row(rf, r0 + lane);
  }
  while (have) {
    const bool more = next();
    if (more) {
      stage_piece(buf + (b ^ 1) * kBufFloats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    const float* sp = buf + b * kBufFloats;
#pragma unroll 8
    for (int i = 0; i < kPiece; ++i, sp += kStride) {
      const float4* v = reinterpret_cast<const float4*>(sp);
      const float4 f0 = v[0];
      // Ng = 0 (a padding slot): denom is +-0 or NaN and no test passes
      if (f0.x == 0.0f && f0.y == 0.0f && f0.z == 0.0f) continue;
      const float4 f1 = v[1], f2 = v[2], f3 = v[3];
      const float f[16] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w};
      const MTHit h = mt_eval(q, [&](int j) { return f[j]; }, kEps);
      if (h.valid && h.t < best) best = h.t;
    }
    __syncwarp();  // the buffer is free for the next piece's copy
    b ^= 1;
    have = more;
  }
  t_out[r0 + lane] = best;
}

template <bool kMasked>
int launch_visits(const int* rows, const float* rf, const float* tri, int R,
                  int Tp, int W, int subg, int n_fixed, float* t_out,
                  void* stream) {
  if (subg <= 0 || subg % 32) return static_cast<int>(cudaErrorInvalidValue);
  visit_kernel<kMasked><<<(R + kThreads - 1) / kThreads, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      rows, rf, tri, R, Tp, W, subg, n_fixed, t_out);
  return static_cast<int>(cudaGetLastError());
}

// B7b.  One block of kMaskThreads threads per 1024 rows of x (R, 16):
// thread t moves float4s t, t + kMaskThreads, ... of the block, its loads
// written ahead of its stores.  With kMask the block's threads compute
// the (32, 16) mask x[0:32, 0:16] > 0.5 of its first rows into shared
// memory (threads 0-127, whose first float4 are those 512 values), store
// their outputs, and after the barrier every thread reads two of the
// mask's words as scalars (a broadcast) and runs a loop they bound; the
// loop's body is an empty volatile statement, so neither the loop nor
// the mask can be dropped, and out = 2 x either way.  The stores go
// before the barrier: behind it they waited for the last of the mask's
// loads (0.7 us a launch of 131,072 rows in 1024-thread blocks).
constexpr int kMaskThreads = 512;
template <bool kMask>
__global__ void __launch_bounds__(kMaskThreads)
block_mask_kernel(const float* __restrict__ x, float* __restrict__ out) {
  constexpr int kVec = kBlk * kNF / 4 / kMaskThreads;  // float4 a thread
  __shared__ int m[kMask ? 32 * kNF : 1];
  const size_t base = static_cast<size_t>(blockIdx.x) * kBlk * kNF / 4;
  const float4* src = reinterpret_cast<const float4*>(x) + base;
  float4* dst = reinterpret_cast<float4*>(out) + base;
  float4 v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = src[threadIdx.x + k * kMaskThreads];
  if (kMask && threadIdx.x < 32 * kNF / 4) {
    int* w = m + 4 * threadIdx.x;
    w[0] = v[0].x > 0.5f ? 1 : 0;
    w[1] = v[0].y > 0.5f ? 1 : 0;
    w[2] = v[0].z > 0.5f ? 1 : 0;
    w[3] = v[0].w > 0.5f ? 1 : 0;
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    float4 a = v[k];
    a.x *= 2.0f;
    a.y *= 2.0f;
    a.z *= 2.0f;
    a.w *= 2.0f;
    dst[threadIdx.x + k * kMaskThreads] = a;
  }
  if constexpr (kMask) {
    __syncthreads();
    const int n = m[0] + m[kNF + 1];  // mask[0, 0] + mask[1, 1]
    for (int i = 0; i < n; ++i) asm volatile("" ::"r"(i));
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
// sg * subg + subg - 1 of the block over tile `tile`.  Pairs naming a
// subgroup or tile outside the block or the table are skipped; count is
// cut at Pw - 1.
//
// The list's work is dealt out in warp items: a pair of subg >= 32 rays
// is subg / 32 items of 32 rays each (kM = 1, a lane a ray), a pair of
// subg < 32 rays one item (kM = 32 / subg lanes a ray: lane l is ray
// l % subg and tests the slots s = l / subg, + kM, ... of each piece).
// Warp w takes items w, w + 32, ... in turn, each staged and tested piece
// by piece; a ray's running min lives in shared memory as the bit pattern
// of a positive f32, where an integer atomicMin is the float min.
constexpr int kPairThreads = kBlk;  // one block a 1024-ray list
constexpr int kPairWarps = kPairThreads / 32;
constexpr int kPairSmem =
    static_cast<int>(sizeof(float)) * kPairWarps * 2 * kBufFloats +
    static_cast<int>(sizeof(int)) * kBlk;

template <int kM>
__global__ void __launch_bounds__(kPairThreads)
pair_slope_kernel(const int* __restrict__ pairs, const float* __restrict__ rf,
                  const float* __restrict__ tri, int Tp, int Pw, int subg,
                  float* __restrict__ t_out) {
  constexpr int kSub = 32 / kM;  // rays an item holds
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const buf = smem + warp * 2 * kBufFloats;  // this warp's two pieces
  int* const t_run = reinterpret_cast<int*>(smem + kPairWarps * 2 * kBufFloats);
  for (int i = threadIdx.x; i < kBlk; i += kPairThreads)
    t_run[i] = __float_as_int(kInf);
  __syncthreads();

  const int r0 = blockIdx.x * kBlk;
  const int* row = pairs + static_cast<size_t>(blockIdx.x) * Pw;
  const int count = min(row[0], Pw - 1);
  const int n_tiles = Tp / kTile;
  const int n_sg = kBlk / subg;
  const int parts = kM == 1 ? subg / 32 : 1;  // items a pair
  const int n_items = count * parts;
  const int ray = lane % kSub;    // this lane's ray within the item
  const int share = lane / kSub;  // its slots: share, share + kM, ...

  // The warp's walk: each piece of each of its items (warp-uniform).
  // first: the item's first ray in the block.
  int it = warp - kPairWarps, piece = kPieces, tile = 0, first = 0;
  const auto next = [&]() {
    if (++piece < kPieces) return true;
    for (it += kPairWarps; it < n_items; it += kPairWarps) {
      const int p = row[1 + it / parts];
      const int sg = p >> 8;
      tile = p & 255;
      if (p >= 0 && sg < n_sg && tile < n_tiles) {
        first = sg * subg + (it % parts) * 32;
        piece = 0;
        return true;
      }
    }
    return false;
  };
  // lane l copies slot l of the piece: one coalesced row at a time
  const auto stage_piece = [&](float* dst) {
    const float* src = tri + tile * kTile + piece * kPiece + lane;
#pragma unroll
    for (int k = 0; k < kNF; ++k)
      cp_async4(dst + lane * kStride + k, src + k * Tp);
    cp_async_commit();
  };

  int b = 0;
  bool have = next();
  if (have) stage_piece(buf);
  Ray q{};
  float best = kInf;
  while (have) {
    const int cur = first, cur_piece = piece;
    if (cur_piece == 0) q = load_ray_row(rf, r0 + cur + ray);
    const bool more = next();
    if (more) {
      stage_piece(buf + (b ^ 1) * kBufFloats);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    const float* sp = buf + b * kBufFloats + share * kStride;
#pragma unroll 4
    for (int i = 0; i < kPiece / kM; ++i, sp += kM * kStride) {
      const float4* v = reinterpret_cast<const float4*>(sp);
      const float4 f0 = v[0];
      // Ng = 0 (a padding slot): denom is +-0 or NaN and no test passes
      if (f0.x == 0.0f && f0.y == 0.0f && f0.z == 0.0f) continue;
      const float4 f1 = v[1], f2 = v[2], f3 = v[3];
      const float f[16] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w};
      const MTHit h = mt_eval(q, [&](int j) { return f[j]; }, kEps);
      if (h.valid && h.t < best) best = h.t;
    }
    __syncwarp();  // the buffer is free for the next piece's copy
    if (cur_piece == kPieces - 1) {  // the item's last piece: merge
#pragma unroll
      for (int o = kSub; o < 32; o <<= 1) {
        const float x = __shfl_xor_sync(0xffffffffu, best, o);
        best = x < best ? x : best;
      }
      if (share == 0 && best < kInf)
        atomicMin(&t_run[cur + ray], __float_as_int(best));
      best = kInf;
    }
    b ^= 1;
    have = more;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kBlk; i += kPairThreads)
    t_out[r0 + i] = __int_as_float(t_run[i]);
}

template <int kM>
int launch_pair_slope(const int* pairs, const float* rf, const float* tri,
                      int R, int Tp, int Pw, int subg, float* t_out,
                      void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      pair_slope_kernel<kM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPairSmem);
  if (e != cudaSuccess) return static_cast<int>(e);
  pair_slope_kernel<kM><<<R / kBlk, kPairThreads, kPairSmem,
                          static_cast<cudaStream_t>(stream)>>>(
      pairs, rf, tri, Tp, Pw, subg, t_out);
  return static_cast<int>(cudaGetLastError());
}

int last_error() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

extern "C" {

// subg must be a positive multiple of 32 (else cudaErrorInvalidValue and
// nothing launched) and divide R (the wrappers check).
int rt_probe_tile_slope(const int* lists, const float* rf, const float* tri,
                        int R, int Tp, int Lw, int subg, float* t_out,
                        void* stream) {
  return launch_visits<false>(lists, rf, tri, R, Tp, Lw, subg, 0, t_out,
                              stream);
}

int rt_probe_uniform_branch(const int* mask, const float* rf,
                            const float* tri, int R, int Tp, int Mw, int subg,
                            int n_fixed, float* t_out, void* stream) {
  return launch_visits<true>(mask, rf, tri, R, Tp, Mw, subg, n_fixed, t_out,
                             stream);
}

// R must be a multiple of 1024 (the wrapper checks).
int rt_probe_block_mask(const float* x, int R, float* out, void* stream) {
  block_mask_kernel<true><<<R / kBlk, kMaskThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, out);
  return last_error();
}

int rt_probe_block_mask_control(const float* x, int R, float* out,
                                void* stream) {
  block_mask_kernel<false><<<R / kBlk, kMaskThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(x, out);
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
  decltype(&launch_pair_slope<1>) run = launch_pair_slope<1>;
  switch (subg) {  // kM = 32 / subg lanes a ray below 32, else 1
    case 1: run = launch_pair_slope<32>; break;
    case 2: run = launch_pair_slope<16>; break;
    case 4: run = launch_pair_slope<8>; break;
    case 8: run = launch_pair_slope<4>; break;
    case 16: run = launch_pair_slope<2>; break;
    default:
      if (subg < 32 || subg % 32 || kBlk % subg)
        return static_cast<int>(cudaErrorInvalidValue);
  }
  return run(pairs, rf, tri, R, Tp, Pw, subg, t_out, stream);
}

}  // extern "C"
