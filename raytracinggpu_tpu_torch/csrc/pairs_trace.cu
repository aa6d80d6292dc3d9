// Pairs mesh traversal kernels for Hopper (sm_90a).
//
// Replaces the Pallas kernel raytracinggpu_tpu/ops/pairs_trace.py::
// _pairs_kernel in its two specializations on the main render path:
//   B1  rt_pairs_closest: closest hit with the geometric-normal payload
//       (_pairs_call(track_idx=True, payload=1));
//   B2  rt_pairs_shadow:  nearest t only (_pairs_call(track_idx=False)).
//
// Contract (the JAX kernel's, not its mechanism):
//   rfT    (16, R) f32 ray-feature rows [u, w = O x u, O, pad];
//   fields (NF, Tc) f32, Tc = nc * tile_t slots; rows 0-2 Ng, 3-5 e2 x A,
//          6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng, 16 original id as f32;
//   bits   (W, R / subg) i32, bit j of word (w, sg) set iff tile 32w+j is
//          active for ray subgroup sg (rays sg*subg .. sg*subg+subg-1);
//          bits naming tiles past Tc / tile_t are ignored.
//   A ray evaluates every slot of every tile active for its subgroup:
//     denom = u.Ng;  beta = (u.(e2 x A) - w.e2) / denom;
//     gamma = (w.e1 - u.(e1 x A)) / denom;  t = (A.Ng - O.Ng) / denom,
//   each division a multiply by rden = 1/denom, every sum left to right.
//   A slot hits when denom != 0, min(beta, gamma, 1-beta-gamma) >= 0 and
//   t > eps.  B1 keeps the lexicographic min of (t, id) and the winner's
//   Ng; a ray whose min is not below INF (1e9 in f32) gets t = INF,
//   idx 0, N = 0.  B2 keeps min(INF, t).
//
// Numerics: build with --fmad=false and IEEE division (no fast math), so
// every product and sum is rounded on its own, as PyTorch's eager
// elementwise ops round them: the kernel is then bitwise equal to the
// plain versions in ops/pairs_trace.py.  The barycentric test is written
// as a conjunction of >= comparisons, which is false on NaN exactly as
// the NaN-propagating min of the reference is (fminf would drop a NaN).
//
// What bounds it on this card: each active (ray, slot) pair costs 17
// field loads and ~45 f32 operations with no reuse across rays in
// registers.  The loads are warp-uniform (all 32 lanes of a warp share
// one subgroup, so they walk the same tiles and read the same address),
// which the L1 serves as one broadcast transaction; the whole cat table
// (655 KB) stays in L2.  So the kernel is issue-bound on the per-slot
// arithmetic plus load instructions, and the work is the number of
// (subgroup, tile) pairs times 128 slots times the subgroup width.
// What the design does about it: one thread per ray, the ray's 9
// features in registers, the bitmask walked with __ffs so culled tiles
// cost nothing, and no shared memory or atomics at all.  Staging tiles
// in shared memory, cp.async/TMA prefetch and per-pair work lists are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e9f;               // 1e9+9 rounded to f32
constexpr float kIdxBig = 1073741824.0f;   // 2^30: id of padding slots
constexpr int kThreads = 128;

template <bool kClosest>
__global__ void __launch_bounds__(kThreads)
pairs_kernel(const float* __restrict__ rfT, const float* __restrict__ fields,
             const int* __restrict__ bits, int R, int Tc, int W, int subg,
             int tile_t, float eps, float* __restrict__ t_out,
             int* __restrict__ idx_out, float* __restrict__ nx_out,
             float* __restrict__ ny_out, float* __restrict__ nz_out) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float ux = rfT[r], uy = rfT[R + r], uz = rfT[2 * R + r];
  const float wx = rfT[3 * R + r], wy = rfT[4 * R + r], wz = rfT[5 * R + r];
  const float ox = rfT[6 * R + r], oy = rfT[7 * R + r], oz = rfT[8 * R + r];
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
        const float n0 = f[0], n1 = f[Tc], n2 = f[2 * Tc];
        const float denom = ux * n0 + uy * n1 + uz * n2;
        const float bnum = (ux * f[3 * Tc] + uy * f[4 * Tc] + uz * f[5 * Tc]) -
                           (wx * f[6 * Tc] + wy * f[7 * Tc] + wz * f[8 * Tc]);
        const float gnum =
            (wx * f[12 * Tc] + wy * f[13 * Tc] + wz * f[14 * Tc]) -
            (ux * f[9 * Tc] + uy * f[10 * Tc] + uz * f[11 * Tc]);
        const float tnum = f[15 * Tc] - (ox * n0 + oy * n1 + oz * n2);
        const float rden = 1.0f / denom;
        const float beta = bnum * rden;
        const float gamma = gnum * rden;
        const float tval = tnum * rden;
        const bool valid = denom != 0.0f && beta >= 0.0f && gamma >= 0.0f &&
                           (1.0f - beta - gamma) >= 0.0f && tval > eps;
        if (!valid) continue;
        if (kClosest) {
          const float id = f[16 * Tc];
          if (tval < best_t || (tval == best_t && id < best_id)) {
            best_t = tval;
            best_id = id;
            bnx = n0;
            bny = n1;
            bnz = n2;
          }
        } else if (tval < best_t) {
          best_t = tval;
        }
      }
    }
  }
  t_out[r] = best_t;
  if (kClosest) {
    const bool hit = best_t < kInf;
    idx_out[r] = hit ? static_cast<int>(best_id) : 0;
    nx_out[r] = hit ? bnx : 0.0f;
    ny_out[r] = hit ? bny : 0.0f;
    nz_out[r] = hit ? bnz : 0.0f;
  }
}

}  // namespace

extern "C" {

int rt_pairs_closest(const float* rfT, const float* fields, const int* bits,
                     int R, int Tc, int W, int subg, int tile_t, float eps,
                     float* t_out, int* idx_out, float* nx_out, float* ny_out,
                     float* nz_out, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  pairs_kernel<true><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out, idx_out, nx_out,
      ny_out, nz_out);
  return static_cast<int>(cudaGetLastError());
}

int rt_pairs_shadow(const float* rfT, const float* fields, const int* bits,
                    int R, int Tc, int W, int subg, int tile_t, float eps,
                    float* t_out, void* stream) {
  const int grid = (R + kThreads - 1) / kThreads;
  pairs_kernel<false><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rfT, fields, bits, R, Tc, W, subg, tile_t, eps, t_out, nullptr, nullptr,
      nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

const char* rt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
