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
// Numerics (mt.cuh): with --fmad=false and IEEE division the kernels
// equal the plain versions in ops/pallas_trace.py bit for bit.  B6's
// result is a min of f32 values and B5's a min of (t, index) pairs under
// their lexicographic order, both exact in any order, and each test's
// arithmetic is mt.cuh's whatever thread runs it, so the mapping below
// changes no bit.
//
// What bounds them on this card: operations.  Each (ray, listed slot) is
// one test of 39 f32 operations (no FMA) plus the compares and the
// running min; the cat's table (262 KB) stays in L1/L2.
//
// The design (pairs_trace.cu's B1/B2 carried over to lists; PERF.md,
// Findings), one template with the winner's index kept or not
// (tiled_kernel<true> is B5, tiled_kernel<false> B6):
//   - each warp walks the union of its rays' lists, a merge: every step
//     takes the least head id among its lanes' lists (__reduce_min_sync)
//     and advances the lists whose head it was.  With subg >= 32 the warp
//     lies in one subgroup and this is its list; at 8 and 16 a warp spans
//     4 or 2 lists, and a tile they share is staged and tested once.  The
//     merge visits every listed id once whatever the order of a list;
//   - a ray whose own list did not name the step's tile tests it with
//     eps = +inf, which no t passes, so it never sees a tile its subgroup
//     culled (the cap culling: B6 would otherwise find occluders past the
//     light).  The min's order-independence makes the union exact;
//   - each tile is staged 32 slots at a time (stage.cuh: slot-major,
//     cp.async, a double buffer a warp; no block barrier), so a test
//     reads its 16 rows as four broadcast 16-byte shared loads;
//   - the slot loop has a compile-time width of 32 (the tile 128, fixed by
//     the wrapper; any other tile width is refused), unrolled 4 times;
//   - B5's index is the slot's position, tile * 128 + piece * 32 + slot:
//     no id row is staged;
//   - a slot whose Ng is zero (padding: 142 of the cat's 4,096) is
//     skipped: its denom is +-0 or NaN, so no test on it passes;
//   - one ray a thread (several measured slower for B1/B2: registers).

#include <cuda_runtime.h>

#include <climits>

#include "mt.cuh"
#include "stage.cuh"

namespace {

constexpr int kIdxBig = 1 << 30;      // index no triangle has
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;            // triangles a tile
constexpr int kPieces = kTile / kPiece;

// kClosest: B5, the lexicographic min of (t, index) and the winner's
// index; else B6, the nearest t (idx_out unused).
template <bool kClosest>
__global__ void __launch_bounds__(kThreads)
tiled_kernel(const float* __restrict__ rfT, const float* __restrict__ fields,
             const int* __restrict__ lists, int R, int Tp, int L, int subg,
             float eps, float* __restrict__ t_out,
             int* __restrict__ idx_out) {
  __shared__ __align__(16) float stage[kWarps][2][kPiece * kStride];

  const int lane = threadIdx.x & 31;
  float(*const buf)[kPiece * kStride] = stage[threadIdx.x >> 5];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const unsigned n_tiles = static_cast<unsigned>(Tp / kTile);
  // a lane past the rays has an empty list but joins its warp's walk
  const Ray q = r < R ? load_ray(rfT, R, r) : Ray{};
  const int* row = lists + (r < R ? r / subg : 0) * L;
  const int count = r < R ? min(row[0], L - 1) : 0;
  float best_t = kInf;
  int best_i = kIdxBig;

  // The warp's walk: each piece of each tile of the merge of its lanes'
  // lists (warp-uniform).  pos: this lane's next list position; mine:
  // this lane's list named the walk's tile.
  int pos = 0, tile = 0, piece = kPieces;
  bool mine = false;
  const auto next = [&]() {
    if (++piece < kPieces) return true;
    int head = INT_MAX;
    for (; pos < count; ++pos) {
      const int id = row[1 + pos];
      if (static_cast<unsigned>(id) < n_tiles) {
        head = id;
        break;
      }
    }
    tile = __reduce_min_sync(0xffffffffu, head);
    if (tile == INT_MAX) return false;
    mine = head == tile;
    pos += mine;
    piece = 0;
    return true;
  };
  // lane l copies slot l of the piece: one coalesced row at a time
  const auto stage_piece = [&](float* dst) {
    const float* src = fields + tile * kTile + piece * kPiece + lane;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      cp_async4(dst + lane * kStride + k, src + k * Tp);
    cp_async_commit();
  };

  int b = 0;
  bool have = next();
  if (have) stage_piece(buf[0]);
  while (have) {
    // a tile this ray's list did not name: eps = +inf, which no t passes
    const float e = mine ? eps : __int_as_float(0x7f800000);
    const int s0 = tile * kTile + piece * kPiece;  // the piece's first index
    const bool more = next();
    if (more) {
      stage_piece(buf[b ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    const float* sp = buf[b];
#pragma unroll 4
    for (int s = 0; s < kPiece; ++s, sp += kStride) {
      const float4* v = reinterpret_cast<const float4*>(sp);
      const float4 f0 = v[0];
      // Ng = 0 (a padding slot): denom is +-0 or NaN and no test passes
      if (f0.x == 0.0f && f0.y == 0.0f && f0.z == 0.0f) continue;
      const float4 f1 = v[1], f2 = v[2], f3 = v[3];
      const float f[16] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w,
                           f2.x, f2.y, f2.z, f2.w, f3.x, f3.y, f3.z, f3.w};
      const MTHit h = mt_eval(q, [&](int i) { return f[i]; }, e);
      if constexpr (kClosest) {
        const int id = s0 + s;
        if (h.valid && (h.t < best_t || (h.t == best_t && id < best_i))) {
          best_t = h.t;
          best_i = id;
        }
      } else {
        if (h.valid && h.t < best_t) best_t = h.t;
      }
    }
    __syncwarp();  // the buffer is free for the next piece's copy
    b ^= 1;
    have = more;
  }
  if (r >= R) return;
  t_out[r] = best_t;
  if constexpr (kClosest) idx_out[r] = best_t < kInf ? best_i : 0;
}

template <bool kClosest>
int launch(const float* rfT, const float* fields, const int* lists, int R,
           int Tp, int L, int subg, int tile_t, float eps, float* t_out,
           int* idx_out, void* stream) {
  if (tile_t != kTile) return static_cast<int>(cudaErrorInvalidValue);
  tiled_kernel<kClosest><<<(R + kThreads - 1) / kThreads, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      rfT, fields, lists, R, Tp, L, subg, eps, t_out, idx_out);
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
