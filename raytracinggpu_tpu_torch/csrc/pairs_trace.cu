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
//   lexicographic min of (t, id); B1 also keeps the winner's Ng, B3 the
//   winner's na*alpha + nb*beta + nc*gamma (per component, summed left to
//   right), computed when the slot wins the update, where its beta and
//   gamma are at hand.  A ray whose min is not below INF (1e9 in f32)
//   gets t = INF, idx 0, N = 0.  B2 keeps min(INF, t).
//
// Numerics (mt.cuh): with --fmad=false and IEEE division the kernels are
// bitwise equal to the plain versions in ops/pairs_trace.py.
//
// What bounds it on this card: each active (ray, slot) pair costs 17
// field loads and ~45 f32 operations with no reuse across rays in
// registers (B3 adds 9 loads and 15 operations per winner update, a few
// per ray).  The loads are warp-uniform (all 32 lanes of a warp share one
// subgroup, so they walk the same tiles and read the same address), which
// the L1 serves as one broadcast transaction; the whole cat table (655 KB)
// stays in L2.  So the kernel is issue-bound on the per-slot arithmetic
// plus load instructions, and the work is the number of (subgroup, tile)
// pairs times 128 slots times the subgroup width.  What the design does
// about it: one thread per ray, the ray's 9 features in registers, the
// bitmask walked with __ffs so culled tiles cost nothing, and no shared
// memory or atomics at all.  Staging tiles in shared memory, cp.async/TMA
// prefetch and per-pair work lists are later work.

#include <cuda_runtime.h>

#include "mt.cuh"

namespace {

constexpr float kIdxBig = 1073741824.0f;   // 2^30: id of padding slots
constexpr int kThreads = 128;

// Template modes; ptxas names the kernels pairs_kernel<0..3> (ILi0E..ILi3E).
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
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const Ray q = load_ray(rfT, R, r);
  const int S = R / subg;
  const int sg = r / subg;
  const int n_tiles = Tc / tile_t;

  float best_t = kInf;
  float best_id = kIdxBig;
  float bnx = 0.0f, bny = 0.0f, bnz = 0.0f;
  for (int w = 0; w < W; ++w) {
    const int left = n_tiles - 32 * w;  // tiles word w can name
    if (left <= 0) break;
    unsigned word = static_cast<unsigned>(bits[w * S + sg]);
    if (left < 32) word &= (1u << left) - 1u;  // bits past the table
    while (word != 0u) {
      const int j = __ffs(static_cast<int>(word)) - 1;
      word &= word - 1u;
      const float* f = fields + (32 * w + j) * tile_t;
      for (int k = 0; k < tile_t; ++k, ++f) {
        const MTHit h = mt_test(q, f, Tc, eps);
        if (!h.valid) continue;
        if constexpr (kMode == kShadow) {
          if (h.t < best_t) best_t = h.t;
        } else {
          const float id = f[16 * Tc];
          if (h.t < best_t || (h.t == best_t && id < best_id)) {
            best_t = h.t;
            best_id = id;
            if constexpr (kMode == kGeom) {
              bnx = h.n0;
              bny = h.n1;
              bnz = h.n2;
            } else if constexpr (kMode == kSmooth) {
              bnx = f[17 * Tc] * h.alpha + f[20 * Tc] * h.beta +
                    f[23 * Tc] * h.gamma;
              bny = f[18 * Tc] * h.alpha + f[21 * Tc] * h.beta +
                    f[24 * Tc] * h.gamma;
              bnz = f[19 * Tc] * h.alpha + f[22 * Tc] * h.beta +
                    f[25 * Tc] * h.gamma;
            }
          }
        }
      }
    }
  }
  t_out[r] = best_t;
  if constexpr (kMode != kShadow) {
    const bool hit = best_t < kInf;
    idx_out[r] = hit ? static_cast<int>(best_id) : 0;
    if constexpr (kMode != kIdx) {
      nx_out[r] = hit ? bnx : 0.0f;
      ny_out[r] = hit ? bny : 0.0f;
      nz_out[r] = hit ? bnz : 0.0f;
    }
  }
}

template <int kMode>
int launch(const float* rfT, const float* fields, const int* bits, int R,
           int Tc, int W, int subg, int tile_t, float eps, float* t_out,
           int* idx_out, float* nx_out, float* ny_out, float* nz_out,
           void* stream) {
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
