// Pairs mesh traversal kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernel raytracinggpu_tpu/ops/pairs_trace.py::
// _pairs_kernel in four specializations, one template mode each:
//   B2  rt_pairs_shadow:         nearest t only (_pairs_call(track_idx=False));
//   B0  rt_pairs_closest_idx:    closest hit, t and id (track_idx=True,
//                                payload=0);
//   B1  rt_pairs_closest:        closest hit with the geometric normal
//                                (payload=1);
//   B3  rt_pairs_closest_smooth: closest hit with the Phong-interpolated
//                                vertex normal (payload=2).
//
// Contract (the JAX kernel's, not its mechanism):
//   rfT    (16, R) f32 ray-feature rows [u, w = O x u, O, pad];
//   fields (NF, Tc) f32, Tc = nc * tile_t slots; rows 0-2 Ng, 3-5 e2 x A,
//          6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng, 16 original id as f32,
//          17-25 the vertex normals na, nb, nc (read by B3 only);
//   bits   (W, R / subg) i32, bit j of word (w, sg) set iff tile 32w+j is
//          active for ray subgroup sg (rays sg*subg .. sg*subg+subg-1);
//          bits naming tiles past Tc / tile_t are ignored.
//   A ray runs the Moller-Trumbore test of mt.cuh on every slot of every
//   tile active for its subgroup.  The closest modes keep the
//   lexicographic min of (t, id), the first slot in (tile, slot) order
//   among equals; B1 returns the winner's Ng, B3 the winner's
//   na*alpha + nb*beta + nc*gamma (per component, summed left to right)
//   from the winner's own beta and gamma.  A ray whose min is not below
//   INF (1e9 in f32) gets t = INF, idx 0, N = 0.  B2 keeps min(INF, t).
//
// Numerics (mt.cuh): with --fmad=false and IEEE division the kernels are
// bitwise equal to the plain versions in ops/pairs_trace.py.  The result
// is a min under a total order, (t, id, slot) or t, and each test's
// arithmetic is mt.cuh's whatever thread runs it, so the mapping below
// changes no bit.
//
// What bounds it on this card: operations.  Each active (ray, slot) pair
// is one test of 39 f32 operations (21 multiplies, 17 adds, a reciprocal,
// each issued alone: no FMA) plus the compares and the running-min
// update; the cat's table (655 KB) and the 200,000-triangle soup's (33.6
// MB) stay in the L2.  The first design (one thread a ray, each test
// reading its 16-17 field rows from device memory as separate strided
// loads, a runtime tile width, the IEEE reciprocal's slow path taken on
// every padding slot) spent about as many issue slots on loads as on
// arithmetic.  What this design does about it (bench/pairs_design.py
// measured the choices; PERF.md, Findings):
//   - each warp walks the OR of its own rays' subgroup words and stages
//     every tile it keeps, 32 slots at a time (one a lane), into a double
//     buffer of its own in shared memory with cp.async, slot-major: a
//     slot's 16 test rows and its id are five broadcast reads.  No block
//     barrier: a walk shared by the block's warps made each warp wait
//     through the tiles of the others' subgroups;
//   - the slot loop has a compile-time width (32), unrolled 4 times;
//   - a slot whose Ng is zero (padding: 23% of the cat's slots) is
//     skipped; its denom is +-0 or NaN, so no test on it passes;
//   - one ray a thread: several rays a thread (each slot read once for
//     all of them) measured slower, for registers and occupancy;
//   - a ray whose own subgroup culled a tile its warp runs takes eps =
//     +inf for it, so its tests never pass and it never takes a culled
//     tile's hit (B2 would otherwise see occluders past the cap);
//   - B1 and B3 keep the winner's slot (and B3 its beta and gamma) and
//     read its normal rows once at the end.

#include <cuda_runtime.h>

#include "mt.cuh"
#include "stage.cuh"

namespace {

constexpr float kIdxBig = 1073741824.0f;   // 2^30: id of padding slots
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

// Template modes; ptxas names the kernels pairs_kernel<0..3>
// (ILi0E..ILi3E).
constexpr int kShadow = 0;  // B2
constexpr int kIdx = 1;     // B0
constexpr int kGeom = 2;    // B1
constexpr int kSmooth = 3;  // B3

template <int kMode>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const float* __restrict__ rfT, const float* __restrict__ fields,
             const int* __restrict__ bits, int R, int Tc, int W, int subg,
             int tile_t, float eps, float* __restrict__ t_out,
             int* __restrict__ idx_out, float* __restrict__ nx_out,
             float* __restrict__ ny_out, float* __restrict__ nz_out) {
  constexpr int kRows = kMode == kShadow ? 16 : 17;  // staged field rows
  __shared__ __align__(16) float stage[kWarps][2][kPiece * kStride];

  const int lane = threadIdx.x & 31;
  float(*const buf)[kPiece * kStride] = stage[threadIdx.x >> 5];
  const int r = blockIdx.x * kThreads + threadIdx.x;
  const int S = R / subg;
  const int n_tiles = Tc / tile_t;
  const int n_pieces = tile_t / kPiece;
  const int n_words = min(W, (n_tiles + 31) / 32);
  const int sg = r < R ? r / subg : -1;  // -1: a lane past the rays
  const Ray q = r < R ? load_ray(rfT, R, r) : Ray{};
  float best_t = kInf, best_id = kIdxBig, best_beta = 0.0f,
        best_gamma = 0.0f;
  int best_slot = -1;

  // The warp's walk: every piece of every tile that the subgroup of one
  // of its rays keeps, in ascending order (warp-uniform).
  int w = -1, tile = -1, piece = 0;
  unsigned word = 0u;
  const auto next = [&]() {
    if (tile >= 0 && ++piece < n_pieces) return true;
    while (word == 0u) {
      if (++w >= n_words) return false;
      const unsigned mine =
          sg >= 0 ? static_cast<unsigned>(bits[w * S + sg]) : 0u;
      const unsigned x = __reduce_or_sync(0xffffffffu, mine);
      const int left = n_tiles - 32 * w;  // tiles word w can name
      word = left < 32 ? x & ((1u << left) - 1u) : x;
    }
    tile = 32 * w + __ffs(static_cast<int>(word)) - 1;
    word &= word - 1u;
    piece = 0;
    return true;
  };
  // lane l copies slot l of the piece: one coalesced row at a time
  const auto stage_piece = [&](float* dst) {
    const float* src = fields + tile * tile_t + piece * kPiece + lane;
#pragma unroll
    for (int row = 0; row < kRows; ++row)
      cp_async4(dst + lane * kStride + row, src + row * Tc);
    cp_async_commit();
  };

  int b = 0;
  bool have = next();
  if (have) stage_piece(buf[0]);
  int cw = -1;        // the bitmask word rw is of
  unsigned rw = 0u;   // this ray's subgroup's word cw
  while (have) {
    const int cur = tile, s0 = tile * tile_t + piece * kPiece;
    const bool more = next();
    if (more) {
      stage_piece(buf[b ^ 1]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();

    if ((cur >> 5) != cw) {
      cw = cur >> 5;
      rw = sg >= 0 ? static_cast<unsigned>(bits[cw * S + sg]) : 0u;
    }
    // a tile this ray's subgroup culled: eps = +inf, which no t passes
    const float e =
        (rw >> (cur & 31)) & 1u ? eps : __int_as_float(0x7f800000);
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
      if constexpr (kMode == kShadow) {
        if (h.valid && h.t < best_t) best_t = h.t;
      } else {
        const float id = sp[16];
        if (h.valid && (h.t < best_t || (h.t == best_t && id < best_id))) {
          best_t = h.t;
          best_id = id;
          best_slot = s0 + s;
          best_beta = h.beta;
          best_gamma = h.gamma;
        }
      }
    }
    __syncwarp();  // the buffer is free for the next piece's copy
    b ^= 1;
    have = more;
  }

  if (r >= R) return;
  t_out[r] = best_t;
  if constexpr (kMode != kShadow) {
    const bool hit = best_t < kInf;
    idx_out[r] = hit ? static_cast<int>(best_id) : 0;
    if constexpr (kMode != kIdx) {
      float n[3] = {0.0f, 0.0f, 0.0f};
      if (hit) {
        const float* f = fields + best_slot;
        if constexpr (kMode == kGeom) {
          for (int c = 0; c < 3; ++c) n[c] = f[c * Tc];
        } else {
          const float alpha = 1.0f - best_beta - best_gamma;  // as mt.cuh's
          for (int c = 0; c < 3; ++c)
            n[c] = f[(17 + c) * Tc] * alpha + f[(20 + c) * Tc] * best_beta +
                   f[(23 + c) * Tc] * best_gamma;
        }
      }
      nx_out[r] = n[0];
      ny_out[r] = n[1];
      nz_out[r] = n[2];
    }
  }
}

template <int kMode>
int launch(const float* rfT, const float* fields, const int* bits, int R,
           int Tc, int W, int subg, int tile_t, float eps, float* t_out,
           int* idx_out, float* nx_out, float* ny_out, float* nz_out,
           void* stream) {
  if (tile_t <= 0 || tile_t % kPiece)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (R + kThreads - 1) / kThreads;
  pairs_kernel<kMode><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out, idx_out, nx_out,
      ny_out, nz_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int rt_pairs_shadow(const float* rfT, const float* fields, const int* bits,
                    int R, int Tc, int W, int subg, int tile_t, float eps,
                    float* t_out, void* stream) {
  return launch<kShadow>(rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out,
                         nullptr, nullptr, nullptr, nullptr, stream);
}

int rt_pairs_closest_idx(const float* rfT, const float* fields,
                         const int* bits, int R, int Tc, int W, int subg,
                         int tile_t, float eps, float* t_out, int* idx_out,
                         void* stream) {
  return launch<kIdx>(rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out,
                      idx_out, nullptr, nullptr, nullptr, stream);
}

int rt_pairs_closest(const float* rfT, const float* fields, const int* bits,
                     int R, int Tc, int W, int subg, int tile_t, float eps,
                     float* t_out, int* idx_out, float* nx_out, float* ny_out,
                     float* nz_out, void* stream) {
  return launch<kGeom>(rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out,
                       idx_out, nx_out, ny_out, nz_out, stream);
}

int rt_pairs_closest_smooth(const float* rfT, const float* fields,
                            const int* bits, int R, int Tc, int W, int subg,
                            int tile_t, float eps, float* t_out, int* idx_out,
                            float* nx_out, float* ny_out, float* nz_out,
                            void* stream) {
  return launch<kSmooth>(rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out,
                         idx_out, nx_out, ny_out, nz_out, stream);
}

const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
