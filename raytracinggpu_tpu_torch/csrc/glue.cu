// The mesh casts' glue and the trace's backward composite, for Hopper
// (sm_90a).
//
// Replace XLA-side work of the JAX package (it has no Pallas kernel for
// any; XLA fuses it into the jitted trace, and the port's plain versions
// are their contracts):
//   rt_ray_rows      the ray-feature rows of a full-width cast:
//                    raytracinggpu_tpu/ops/pairs_trace.py::_ray_feature_rows
//                    and raytracinggpu_tpu/ops/pallas_trace.py::
//                    _ray_features16 (port: ops/pallas_trace.py::
//                    ray_rows_plain);
//   rt_compact_rows  a compacted cast's source lanes and its rows at those
//                    lanes: the mask of _compact_sort and the jnp.take of
//                    the live rows (port: ops/pairs_trace.py::
//                    compact_rows_plain);
//   rt_scatter       a compacted cast's outputs at full width: the
//                    .at[src].set over the no-hit defaults (port:
//                    ops/pairs_trace.py::scatter_plain);
//   rt_composite     the backward composite, the jax.lax.scan(...,
//                    reverse=True) of raytracinggpu_tpu/integrator/
//                    wavefront.py::trace (port: integrator/wavefront.py::
//                    composite_plain).
//
// Contract:
//   rt_ray_rows / rt_compact_rows write rows (nrows, n) f32 of lanes
//   lane(i), i < n: lane(i) = i (rt_ray_rows, n = R), or key[i] & mask of
//   the sorted keys (rt_compact_rows, n = C; src[i] = lane(i) and, with
//   active, active_out[i] = active[lane(i)]).  Rows: u(3), w = O x u(3),
//   O(3); then either (rcp) 1 / u(3) and zeros to 16, or the extras (cap;
//   or, with active, cap or a zero row and active as 1.0 / 0.0) and zeros
//   to nrows.
//   rt_scatter: for each i < Rp, lane = key[i] & mask, out_k[lane] =
//   in_k[i] for i < C, else the k-th default; the sorted keys are a
//   permutation of the lanes, so every lane is written once (a key whose
//   lane is past Rp is skipped).  The outputs are 32-bit words (f32 or
//   int32), copied as bits.
//   rt_composite: per lane, per channel c, ans = 0 (or the carried ans),
//   then for d = D-1 ... 0, ans = is_diff[d] ? fma64(alb[d][c], ans,
//   direct[d][c]) : ans.  A launch takes at most kMaxDepths depths through
//   its parameter struct (no copy to the card); the wrapper chunks a
//   deeper trace, the later chunks carrying ans through its output.
//
// Numerics: bitwise the torch ops of the plain versions on the card.
// Built with --fmad=false.  w rounds as core/vec.py's Vec3.cross on the
// card: the product c * d is an f32 product, negated, added to the exact
// f64 product of a and b in f64 (DMUL then DADD), the sum rounded to f32
// (fma64 below; never __fmaf_rn, which rounds once and differs at an f32
// midpoint).  1.0 / u is torch's reciprocal then a product by 1.0 (an
// f32 tensor's __rtruediv__), the IEEE reciprocal (-prec-div=true, no
// flush of denormals) times 1.0, which changes no bit of a number.
// rt_composite's fma64 is core/vec.fma, torch's f64 casts, product, sum
// and cast.  A NaN's payload may follow the instruction that carried it
// (torch's f64 add is a DFMA with the operands in another order), as in
// csrc/wavefront.cu.
//
// What bounds them on this card: bytes.  One thread a lane (a position of
// the sorted keys for rt_compact_rows and rt_scatter), its rows written
// coalesced.  rt_ray_rows reads 24 bytes a lane and writes 36 to 64;
// rt_compact_rows reads a key and its lane's O and u (and cap, active)
// scattered within a key group (the lanes of a group ascend) and writes
// its rows coalesced; rt_scatter reads the whole sorted key array once,
// which the sort already made, so that it needs no fill pass and no
// inverse map: each position writes its lane's words once (the writes
// scatter, reads coalesce); rt_composite keeps ans in registers across the
// depths and reads each depth's 7 words a lane once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxOut = 5;      // outputs a scattered cast has at most
constexpr int kMaxDepths = 8;   // depths a composite launch takes

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

// ------------------------------------------- rt_ray_rows, rt_compact_rows

struct RowsArgs {
  const float* O[3];
  const float* u[3];
  const float* cap;      // or null
  const bool* active;    // or null
  const int* keys;       // kCompact: the sorted keys
  float* rows;           // (nrows, n)
  int* src;              // kCompact: (n,) the source lanes
  bool* active_out;      // kCompact with active: (n,)
  int n, nrows, rcp, mask;
};

template <bool kCompact>
__global__ void __launch_bounds__(kThreads) rows_kernel(RowsArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.n) return;
  const int lane = kCompact ? (__ldg(a.keys + i) & a.mask) : i;
  const float ox = a.O[0][lane], oy = a.O[1][lane], oz = a.O[2][lane];
  const float ux = a.u[0][lane], uy = a.u[1][lane], uz = a.u[2][lane];
  float* r = a.rows + i;
  const int n = a.n;
  r[0 * n] = ux;
  r[1 * n] = uy;
  r[2 * n] = uz;
  // Vec3.cross of O and u: fma(a, b, -(c * d)) a component
  r[3 * n] = fma64(oy, uz, -(oz * uy));
  r[4 * n] = fma64(oz, ux, -(ox * uz));
  r[5 * n] = fma64(ox, uy, -(oy * ux));
  r[6 * n] = ox;
  r[7 * n] = oy;
  r[8 * n] = oz;
  int k = 9;
  if (a.rcp) {
    r[9 * n] = 1.0f / ux;
    r[10 * n] = 1.0f / uy;
    r[11 * n] = 1.0f / uz;
    k = 12;
  } else if (a.active) {
    const bool act = a.active[lane];
    r[9 * n] = a.cap ? a.cap[lane] : 0.0f;
    r[10 * n] = act ? 1.0f : 0.0f;
    k = 11;
    if (kCompact) a.active_out[i] = act;
  } else if (a.cap) {
    r[9 * n] = a.cap[lane];
    k = 10;
  }
  for (; k < a.nrows; ++k) r[k * n] = 0.0f;
  if (kCompact) a.src[i] = lane;
}

// ------------------------------------------------------------ rt_scatter

struct ScatterArgs {
  const int* keys;              // (Rp,) the sorted keys
  const uint32_t* in[kMaxOut];  // (C,) each
  uint32_t* out[kMaxOut];       // (Rp,) each
  uint32_t dflt[kMaxOut];       // the defaults' bits
  int n_out, C, Rp, mask;
};

__global__ void __launch_bounds__(kThreads) scatter_kernel(ScatterArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.Rp) return;
  const int lane = __ldg(a.keys + i) & a.mask;
  if (lane >= a.Rp) return;  // not a permutation of the lanes: no write
  const bool cast = i < a.C;
#pragma unroll
  for (int k = 0; k < kMaxOut; ++k)
    if (k < a.n_out) a.out[k][lane] = cast ? a.in[k][i] : a.dflt[k];
}

// ------------------------------------------------------------ rt_composite

struct CompositeArgs {
  const bool* is_diff[kMaxDepths];  // (R,) each
  const float* direct[kMaxDepths];  // (3, R) each
  const float* alb[kMaxDepths];     // (3, R) each
  float* ans;                       // (3, R)
  int D, carry, R;
};

__global__ void __launch_bounds__(kThreads)
    composite_kernel(CompositeArgs a) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= a.R) return;
  const int R = a.R;
  float x = 0.0f, y = 0.0f, z = 0.0f;
  if (a.carry) {
    x = a.ans[i];
    y = a.ans[R + i];
    z = a.ans[2 * R + i];
  }
  for (int d = a.D - 1; d >= 0; --d) {
    if (!a.is_diff[d][i]) continue;
    const float* al = a.alb[d];
    const float* di = a.direct[d];
    x = fma64(al[i], x, di[i]);
    y = fma64(al[R + i], y, di[R + i]);
    z = fma64(al[2 * R + i], z, di[2 * R + i]);
  }
  a.ans[i] = x;
  a.ans[R + i] = y;
  a.ans[2 * R + i] = z;
}

int grid(int n) { return (n + kThreads - 1) / kThreads; }

// the next pointer(s) of a launch's array, into a field of its struct
template <typename P>
void take(P& dst, void* const* p, int& k) {
  dst = static_cast<P>(p[k++]);
}
template <typename P, int N>
void take(P (&dst)[N], void* const* p, int& k) {
  for (int j = 0; j < N; ++j) dst[j] = static_cast<P>(p[k++]);
}

int finish() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// Each C function takes its tensors as one array of device pointers (ops/
// _kernels.py builds it), launches on `stream` and returns the launch's
// CUDA error (0 on success).
extern "C" {

// p: O(3), u(3), cap, active, rows (cap and active null when absent)
int rt_ray_rows(void* const* p, int R, int nrows, int rcp, void* stream) {
  RowsArgs a{};
  int k = 0;
  take(a.O, p, k);
  take(a.u, p, k);
  take(a.cap, p, k);
  take(a.active, p, k);
  take(a.rows, p, k);
  a.n = R;
  a.nrows = nrows;
  a.rcp = rcp;
  rows_kernel<false><<<grid(R), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return finish();
}

// p: O(3), u(3), cap, active, keys, rows, src, active_out (cap, active and
// active_out null when absent)
int rt_compact_rows(void* const* p, int C, int nrows, int mask,
                    void* stream) {
  RowsArgs a{};
  int k = 0;
  take(a.O, p, k);
  take(a.u, p, k);
  take(a.cap, p, k);
  take(a.active, p, k);
  take(a.keys, p, k);
  take(a.rows, p, k);
  take(a.src, p, k);
  take(a.active_out, p, k);
  a.n = C;
  a.nrows = nrows;
  a.mask = mask;
  rows_kernel<true><<<grid(C), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return finish();
}

// p: keys, in(n_out), out(n_out); dflt: the n_out defaults' bits
int rt_scatter(void* const* p, const uint32_t* dflt, int n_out, int C,
               int Rp, int mask, void* stream) {
  if (n_out < 1 || n_out > kMaxOut) return cudaErrorInvalidValue;
  ScatterArgs a{};
  int k = 0;
  take(a.keys, p, k);
  for (int j = 0; j < n_out; ++j) take(a.in[j], p, k);
  for (int j = 0; j < n_out; ++j) take(a.out[j], p, k);
  for (int j = 0; j < n_out; ++j) a.dflt[j] = dflt[j];
  a.n_out = n_out;
  a.C = C;
  a.Rp = Rp;
  a.mask = mask;
  scatter_kernel<<<grid(Rp), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return finish();
}

// p: is_diff(D), direct(D), alb(D), ans; D in [1, rt_composite_max_depths()]
int rt_composite(void* const* p, int D, int carry, int R, void* stream) {
  if (D < 1 || D > kMaxDepths) return cudaErrorInvalidValue;
  CompositeArgs a{};
  int k = 0;
  for (int d = 0; d < D; ++d) take(a.is_diff[d], p, k);
  for (int d = 0; d < D; ++d) take(a.direct[d], p, k);
  for (int d = 0; d < D; ++d) take(a.alb[d], p, k);
  take(a.ans, p, k);
  a.D = D;
  a.carry = carry;
  a.R = R;
  composite_kernel<<<grid(R), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return finish();
}

int rt_composite_max_depths() { return kMaxDepths; }

}  // extern "C"
