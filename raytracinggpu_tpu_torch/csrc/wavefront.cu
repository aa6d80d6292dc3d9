// The wavefront depth step's per-lane math and the primary rays, for Hopper
// (sm_90a).
//
// Replace XLA-side work of the JAX package (it has no Pallas kernel for any;
// XLA fuses it inside render_rows' jitted program, and the port's plain
// versions are their contracts):
//   rt_sphere_hit    raytracinggpu_tpu/ops/sphere.py::intersect_spheres
//                    (port: ops/sphere.py::sphere_hit_plain), the nearest
//                    sphere of every ray; run on the closest rays and on the
//                    shadow rays of every depth;
//   rt_shade         the sphere/mesh merge of raytracinggpu_tpu/integrator/
//                    wavefront.py::intersect_all and the materials, mirror,
//                    refraction, shadow ray and light term of its
//                    _depth_step (port: integrator/wavefront.py::shade_plain);
//   rt_bounce        the rest of _depth_step: occlusion, the direct term and
//                    the cosine-weighted bounce of core/rng.py::
//                    cosine_hemisphere (port: integrator/wavefront.py::
//                    bounce_plain);
//   rt_primary_rays  render/pipeline.py's per-sample fold_in, row_uniforms
//                    (threefry2x32, partitionable), box_muller terms and
//                    raygen (port: render/pipeline.py::primary_rays_plain).
//
// Numerics: each kernel is bitwise the sequence of PyTorch ops of its plain
// version as those ops run on the card.  Built with --fmad=false, so a * b +
// c rounds twice unless written as fma64 (core/vec.fma: the f64 product of
// two f32 values is exact, the f64 sum is rounded once to f64 and once to
// f32; DMUL then DADD, never __fmaf_rn).  sqrt, cos and sin are the f64
// functions rounded to f32 (libdevice, as torch's f64 kernels call them);
// log is the Cephes polynomial of core/vec.log.  A Python float times an f32
// tensor is an f32 product with the float rounded first; an f32 tensor over a
// Python float is a product with the f32 reciprocal on the card (torch's
// div_true_kernel_cuda takes a CPU scalar's reciprocal), over a tensor an
// IEEE division.  torch.clamp_min and torch.minimum pass NaN through, so
// they are not fmaxf / fminf alone.  torch.argmin keeps the first of equal
// values and the first NaN, as the scans here do; torch.amin's value is the
// argmin's (both differ only in the sign of a zero that ties a zero of
// another sphere, which the scans do not mimic).  A NaN's sign and payload
// are not reproduced: the card keeps an f64 operand's payload through DADD,
// DMUL and DFMA, and torch's f64 add is a DFMA with the operands in another
// order, so a lane with two NaN inputs may keep the other one.
//
// What bounds them on this card: bytes.  Each is one thread a lane, its
// lane's structure-of-arrays rows read and written once, coalesced; the
// scene's constants (spheres, materials, light, camera, key) are read from
// device pointers, never copied to the host.  rt_primary_rays does about a
// thousand 32-bit integer operations a lane (12 threefry hashes at depth 5),
// which at the card's INT32 rate is more than its bytes (chip_smoke.py's
// phase 21 computes both).  rt_sphere_hit's loop over the spheres is bound
// by its instructions (its section); rt_f32_identities checks the
// identities that loop rests on, over every f32.  The counts of rt_shade
// and rt_bounce are block sums (__syncthreads_count) added with one 64-bit
// atomic a block, so their order does not matter.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 1e9f;            // the reference INF (1e9 + 9) in f32
constexpr float kPi = 3.14159274101257324f;  // float(np.float32(np.pi))
constexpr float kFourPi = 4.0f * kPi;   // 4.0 * PI, exact
constexpr float kInvPi = 1.0f / kPi;    // the card's lum / PI
// 2.0 * math.pi, rounded to f32 when it multiplies an f32 tensor
constexpr float kTwoPi = static_cast<float>(6.283185307179586);

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}
__device__ __forceinline__ float sqrt32(float x) {
  return static_cast<float>(sqrt(static_cast<double>(x)));
}
__device__ __forceinline__ float cos32(float x) {
  return static_cast<float>(cos(static_cast<double>(x)));
}
__device__ __forceinline__ float sin32(float x) {
  return static_cast<float>(sin(static_cast<double>(x)));
}
// torch.clamp_min(x, 0.0) on the card: NaN passes, else ::max
__device__ __forceinline__ float clamp_min0(float x) {
  return isnan(x) ? x : fmaxf(x, 0.0f);
}
// torch.minimum on the card: the first NaN, else ::min
__device__ __forceinline__ float minimum(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}
__device__ __forceinline__ V3 load3(const float* const p[3], int i) {
  return V3{p[0][i], p[1][i], p[2][i]};
}
__device__ __forceinline__ void store3(float* const p[3], int i, V3 v) {
  p[0][i] = v.x;
  p[1][i] = v.y;
  p[2][i] = v.z;
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return V3{a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 sel(bool m, V3 a, V3 b) { return m ? a : b; }
// Vec3.dot: fma(z, z', fma(x, x', y * y'))
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return fma64(a.z, b.z, fma64(a.x, b.x, a.y * b.y));
}
__device__ __forceinline__ float norm(V3 a) { return sqrt32(dot(a, a)); }
__device__ __forceinline__ V3 divs(V3 a, float s) {
  return V3{a.x / s, a.y / s, a.z / s};
}
// Vec3.fma: a * s + c a component, s a scalar
__device__ __forceinline__ V3 fmas(V3 a, float s, V3 c) {
  return V3{fma64(a.x, s, c.x), fma64(a.y, s, c.y), fma64(a.z, s, c.z)};
}
// Vec3.cross: fma(a, b, -(c * d)) a component
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return V3{fma64(a.y, b.z, -(a.z * b.y)), fma64(a.z, b.x, -(a.x * b.z)),
            fma64(a.x, b.y, -(a.y * b.x))};
}

// Adds the block's count of lanes where `pred` holds to *dst (every thread of
// the block must call it).
__device__ __forceinline__ void count(bool pred, long long* dst) {
  int c = __syncthreads_count(pred);
  if (threadIdx.x == 0 && c)
    atomicAdd(reinterpret_cast<unsigned long long*>(dst),
              static_cast<unsigned long long>(c));
}

// ------------------------------------------------------------ rt_sphere_hit
//
// The sphere loop holds every f32 value of sphere_hit_plain in an f64
// register and rounds it to f32 precision without a conversion (F2F.F64.F32
// and F2F.F32.F64 issue at 16 a clock on an SM, an eighth of the f32 rate;
// the loop of conversions took about 16 a sphere):
//   - round24(x) = c - (c - x), c = x * (2^29 + 1), Veltkamp's split in three
//     f64 operations, is x rounded to 24 significant bits, to nearest, ties
//     to even: (double)(float)x wherever the result is 0 or its magnitude
//     lies in [2^-126, 2^128), where an f32 rounds to 24 bits too
//     (--fmad=false keeps c - x from becoming fma(x, 2^29 + 1, -x));
//   - an f32 operation on f32 values is the f64 operation rounded by
//     round24: the f64 result is the exact one rounded once to 53 bits, and
//     53 >= 2 * 24 + 1 makes that first rounding harmless (Figueroa).  An
//     fma64 (core/vec.fma) is one DFMA rounded by round24: the product of two
//     f32 values is exact in f64, so DMUL then DADD and DFMA round the same
//     sum once;
//   - sqrt32 is sqrtf (IEEE without fast math): the f64 root rounded to f32
//     is the f32 root (53 >= 2 * 24 + 2).  Both roots leave their fast
//     sequence for a slow call on 0, which half the lanes give (their ray
//     misses the sphere: delta < 0, clamped); the loop takes 0 for the root
//     of 0 and hands sqrtf 1 there;
//   - narrow24 reads the f32 out of an f64 that holds 0 or an f32 normal
//     with four integer operations.
// Where that is exact: a lane's O and u and the table's centres and radii
// each 0 or of magnitude in [2^-40, 2^30) (moderate(): rays and scenes are,
// by far).  Then an f32 of the loop is a multiple of 2^-63, so are the
// differences oc; the products of two, their sums and every rounding of
// them are multiples of 2^-126 below 2^65: 0 or f32 normals.  Only delta =
// b * b - e, a multiple of 2^-252, can fall between 0 and 2^-126, so the
// loop keeps the least tiny_key of its deltas (two integer operations a
// sphere).  A lane that fails a check, or a table that does, runs the
// loop of conversions (exact_nearest): the rare path, right for every
// input (NaN, inf, huge, f32 subnormals).  The closest mode's normal keeps
// the f32 sequence with its conversions, once a lane, beside the
// conversion pipe the loop leaves free.  The table is widened once a block into shared
// memory (c, and the f32 r * r), kSphereChunk spheres at a time.  One lane
// a thread: two, sharing the table's reads between two chains, measured
// no faster.
// What bounds it: a lane and sphere issue about 90 instructions, 44 of them
// f64 (bench/sphere_scatter_design.py counts them in the SASS);
// exact_nearest's loop issues about 88, 15 of them F2F, and runs about as
// long: both are bound by their instructions' issue and latency, not by
// the conversion pipe.

constexpr double kSplit = 536870913.0;  // 2^29 + 1
constexpr int kSphereChunk = 64;        // spheres a block widens at a time
// tiny_key(x) of an f64 x is below kTinyKey exactly when 0 < |x| < 2^-126
// (an f64 biased exponent under 897), for x 0 or at least 2^-1042 in
// magnitude (its high word not 0; a delta is a multiple of 2^-252)
constexpr unsigned kTinyKey = (897u << 21) - 1u;

__device__ __forceinline__ double round24(double x) {
  const double c = x * kSplit;
  return c - (c - x);
}
// (hi << 1) - 1 of x's bits: the sign dropped, 0 wrapped to the top
__device__ __forceinline__ unsigned tiny_key(double x) {
  return (static_cast<unsigned>(__double2hiint(x)) << 1) - 1u;
}
__device__ __forceinline__ float narrow24(double x) {
  const unsigned hi = __double2hiint(x), lo = __double2loint(x);
  // the f32 exponent in place of the f64 one (an f32 normal's biased f64
  // exponent lies in [897, 1150]); a zero goes below 0 and is held at 0
  const int e = max(static_cast<int>(hi & 0x7fffffffu) - (896 << 20), 0);
  return __uint_as_float(__funnelshift_l(lo, static_cast<unsigned>(e), 3) |
                         (hi & 0x80000000u));
}
// 0, or of magnitude in [2^-40, 2^30) (biased f32 exponents 87 to 156)
__device__ __forceinline__ bool moderate(float v) {
  const unsigned m = __float_as_uint(v) & 0x7fffffffu;
  return m == 0u || m - (87u << 23) < (70u << 23);
}

struct SphereArgs {
  const float* O[3];
  const float* u[3];
  const float* c[3];     // sphere centres (S,)
  const float* radius;   // (S,)
  const bool* active;    // shadow mode: the pairs cast's active lanes, or null
  const float* lv2;      // with active: |L - P_adj|^2
  float* t;
  int* obj;              // full mode
  float* N[3];           // full mode
  bool* active_out;      // with active
  int S;
};

// sphere_hit_plain's loop with its conversions (fma64, sqrt32): the nearest
// sphere's t and index, torch.argmin's choice (the first minimum, the first NaN before any number).
// Inlined: an out-of-line call cost the fast lanes more than its registers
__device__ void exact_nearest(const SphereArgs& a, V3 O, V3 u, float& best,
                              int& arg) {
  best = 0.0f;
  arg = 0;
  for (int s = 0; s < a.S; ++s) {
    const float r = __ldg(a.radius + s);
    const V3 oc = sub(O, V3{__ldg(a.c[0] + s), __ldg(a.c[1] + s),
                            __ldg(a.c[2] + s)});
    const float b = dot(u, oc);
    const float delta = fma64(b, b, -(dot(oc, oc) - r * r));
    const float sq = sqrt32(clamp_min0(delta));
    const float nb = -b;
    const float t1 = nb - sq, t2 = nb + sq;
    const bool valid = (delta >= 0.0f) && (t2 >= 0.0f);
    float t = t1 < 0.0f ? t2 : t1;
    t = valid ? t : kInf;
    if (s == 0 || (isnan(t) ? !isnan(best) : t < best)) {
      best = t;
      arg = s;
    }
  }
}

// kFull: (t, obj, N) of ops/sphere.py::sphere_hit_plain; else t alone, and
// with `active` the pairs shadow cast's active lanes, active & ~(t * t <=
// lv2) (a lane a sphere occludes needs no mesh work).
template <bool kFull>
__global__ void __launch_bounds__(kThreads)
    sphere_kernel(SphereArgs a, int R) {
  __shared__ double4 tab[kSphereChunk];  // centre, the f32 r * r
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < R;
  const V3 O = in ? load3(a.O, i) : V3{0.0f, 0.0f, 0.0f};
  const V3 u = in ? load3(a.u, i) : V3{0.0f, 0.0f, 0.0f};
  const bool fast = moderate(O.x) && moderate(O.y) && moderate(O.z) &&
                    moderate(u.x) && moderate(u.y) && moderate(u.z);
  const double ox = O.x, oy = O.y, oz = O.z, ux = u.x, uy = u.y, uz = u.z;
  float best = INFINITY;
  int arg = 0;
  unsigned tiny = ~0u;
  bool table_ok = true;
  for (int s = threadIdx.x; s < a.S; s += kThreads)
    table_ok = table_ok && moderate(__ldg(a.c[0] + s)) &&
               moderate(__ldg(a.c[1] + s)) && moderate(__ldg(a.c[2] + s)) &&
               moderate(__ldg(a.radius + s));
  table_ok = __syncthreads_and(table_ok);
  for (int base = 0; table_ok && base < a.S; base += kSphereChunk) {
    const int n = min(kSphereChunk, a.S - base);
    if (base) __syncthreads();  // the previous chunk is read
    for (int s = threadIdx.x; s < n; s += kThreads) {
      const float r = __ldg(a.radius + base + s);
      tab[s] = double4{__ldg(a.c[0] + base + s), __ldg(a.c[1] + base + s),
                       __ldg(a.c[2] + base + s), r * r};
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      const double4 q = tab[s];
      // sphere_hit_plain's f32 values, each rounded by round24
      const double ocx = round24(ox - q.x);
      const double ocy = round24(oy - q.y);
      const double ocz = round24(oz - q.z);
      const double b = round24(
          fma(uz, ocz, round24(fma(ux, ocx, round24(uy * ocy)))));
      const double n2 = round24(
          fma(ocz, ocz, round24(fma(ocx, ocx, round24(ocy * ocy)))));
      const double delta = round24(fma(b, b, -round24(n2 - q.w)));
      tiny = min(tiny, tiny_key(delta));
      // the f32 steps in f32: delta is not NaN here, t never.  sqrtf takes
      // a slow path for 0 (a ray that misses the sphere), so a root of 0
      // is 0 itself
      const float dl = narrow24(delta), nb = -narrow24(b);
      const float c0 = fmaxf(dl, 0.0f);  // clamp_min0 but for NaN
      const float root = sqrtf(c0 > 0.0f ? c0 : 1.0f);
      const float sq = c0 > 0.0f ? root : c0;
      const float t1 = nb - sq, t2 = nb + sq;
      const bool valid = (dl >= 0.0f) && (t2 >= 0.0f);
      float t = t1 < 0.0f ? t2 : t1;
      t = valid ? t : kInf;
      if (t < best) {
        best = t;
        arg = base + s;
      }
    }
  }
  if (!in) return;
  if (!(table_ok && fast && tiny >= kTinyKey))
    exact_nearest(a, O, u, best, arg);
  a.t[i] = best;
  const bool hit = best < kInf;
  if (kFull) {
    const int obj = hit ? arg : -1;
    a.obj[i] = obj;
    const int w = obj < 0 ? a.S - 1 : obj;  // -1 gathers the last sphere
    const V3 n = sub(fmas(u, best, O), V3{__ldg(a.c[0] + w),
                                          __ldg(a.c[1] + w),
                                          __ldg(a.c[2] + w)});
    const float nn = hit ? norm(n) : 1.0f;
    store3(a.N, i, divs(n, nn));
  } else if (a.active_out) {
    a.active_out[i] = a.active[i] && !(best * best <= a.lv2[i]);
  }
}

// ------------------------------------------------- the sphere loop's checks
//
// rt_f32_identities: the identities rt_sphere_hit's loop rests on, over the
// f32 bit patterns first, first + 1, ... (n of them, modulo 2^32), added to
// counts (IDENTITY_COUNTS of ops/_kernels.py, in order):
//   [0] patterns;
//   [1] of them, sqrtf(x) unlike sqrt32(x) (NaN alike);
//   [2] doubles d tested: for each finite x, x and x +- half its ulp, and
//       each of those one f64 ulp up and down (ties, and next to ties),
//       but for the f64 subnormals under 2^-1042 next to x = 0, which no
//       delta is (tiny_key's domain);
//   [3] of them, round24(d) accepted: tiny_key at least kTinyKey (the loop's
//       test of delta) and below 2^128 (what moderate() inputs keep to);
//   [4] accepted, and round24(d) unlike (double)(float)d;
//   [5] accepted, and narrow24(round24(d)) unlike (float)d, bit for bit;
//   [6] rejected, though (float)d is 0 or an f32 normal (the rare path taken
//       where the fast one was right: coverage, not a fault).
constexpr int kIdentityCounts = 7;

__global__ void __launch_bounds__(kThreads)
    identities_kernel(unsigned long long first, unsigned long long n,
                      unsigned long long* counts) {
  unsigned c[kIdentityCounts] = {};
  const unsigned long long stride =
      static_cast<unsigned long long>(gridDim.x) * kThreads;
  for (unsigned long long k = blockIdx.x * kThreads + threadIdx.x; k < n;
       k += stride) {
    const unsigned bits = static_cast<unsigned>(first + k);
    const float x = __uint_as_float(bits);
    c[0] += 1;
    const float s1 = sqrtf(x), s2 = sqrt32(x);
    c[1] += !(__float_as_uint(s1) == __float_as_uint(s2) ||
              (isnan(s1) && isnan(s2)));
    if (!isfinite(x)) continue;
    const int ex = max(static_cast<int>((bits >> 23) & 0xffu), 1);
    const double h = __hiloint2double((ex - 151 + 1023) << 20, 0);
    const double xd = x;
    for (int m = -1; m <= 1; ++m) {
      for (int step = -1; step <= 1; ++step) {
        const double dv = __longlong_as_double(
            __double_as_longlong(xd + m * h) + step);
        if (dv != 0.0 && fabs(dv) < 0x1p-1042) continue;
        const double r = round24(dv);
        const float want = static_cast<float>(dv);
        c[2] += 1;
        const bool ok = tiny_key(r) >= kTinyKey && fabs(r) < 0x1p128;
        if (ok) {
          c[3] += 1;
          c[4] += !(__double_as_longlong(r) ==
                    __double_as_longlong(static_cast<double>(want)));
          c[5] += __float_as_uint(narrow24(r)) != __float_as_uint(want);
        } else {
          c[6] += want == 0.0f ||
                  (fabsf(want) >= 0x1p-126f && isfinite(want));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kIdentityCounts; ++j) {
    const unsigned w = __reduce_add_sync(0xffffffffu, c[j]);
    if ((threadIdx.x & 31) == 0 && w)
      atomicAdd(counts + j, static_cast<unsigned long long>(w));
  }
}

// ------------------------------------------------------------ rt_shade

struct ShadeArgs {
  const float* O[3];
  const float* u[3];
  const float* ri;
  const float* ts;       // rt_sphere_hit's t, obj, N on these rays
  const int* obj;
  const float* Ns[3];
  const float* tm;       // the mesh cast's t and unnormalised normal, or null
  const float* Nm[3];
  const float* albedo[3];  // the material table, (M,)
  const bool* mirror;
  const float* in_ri;
  const float* out_ri;
  const float* L[3];     // 0-d
  const float* intensity;  // 0-d
  float* O2[3];          // the next ray: origin, direction (the diffuse lanes'
  float* u2[3];          // rt_bounce fills), medium
  float* ri2;
  float* S[3];           // the shadow ray: P_adj, direction, |Lv|, |Lv|^2
  float* d[3];
  float* cap;
  float* lv2;
  float* N[3];           // the unit normal at the hit
  float* alb[3];         // the hit object's albedo
  float* lum;            // lum / PI
  bool* is_diff;
  bool* sh_active;       // diffuse, light in front: the shadow query counts
  long long* counts;     // += hit, mirror, refract, tir, diffuse
  int mesh_id;
  float eps;
};

__global__ void __launch_bounds__(kThreads) shade_kernel(ShadeArgs a, int R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < R;
  bool hit = false, is_mirror = false, is_refr = false, is_tir = false,
       is_diff = false;
  if (in) {
    const V3 O = load3(a.O, i), u = load3(a.u, i);
    const float ri = a.ri[i];
    // ---- intersect_all's merge: the mesh wins only strictly ----
    float t = a.ts[i];
    int obj = a.obj[i];
    V3 N = load3(a.Ns, i);
    if (a.tm) {
      V3 Nm = load3(a.Nm, i);
      const float nn = norm(Nm);
      Nm = divs(Nm, nn > 0.0f ? nn : 1.0f);
      const float tm = a.tm[i];
      const bool use_mesh = tm < t;
      t = use_mesh ? tm : t;
      obj = use_mesh ? a.mesh_id : obj;
      obj = t < kInf ? obj : -1;
      N = sel(use_mesh, Nm, N);
    }
    hit = obj >= 0;
    const V3 P = fmas(u, hit ? t : 0.0f, O);
    // ---- materials ----
    const int oid = obj < 0 ? 0 : obj;
    const bool mir = a.mirror[oid];
    const float in_ri = a.in_ri[oid], out_ri = a.out_ri[oid];
    is_mirror = hit && mir;
    is_refr = hit && !mir && (in_ri != out_ri);
    is_diff = hit && !is_mirror && !is_refr;
    const float eps = a.eps;
    // ---- mirror ----
    const V3 u_mir = fmas(neg(N), 2.0f * dot(u, N), u);
    const V3 O_mir = fmas(N, eps, P);
    // ---- refraction ----
    const bool out2in = ri == out_ri;
    const float ratio = out2in ? out_ri / in_ri : in_ri / out_ri;
    const V3 N2 = sel(out2in, N, neg(N));
    const float cosi = dot(u, N2);
    const float sin2t = ratio * ratio * fma64(-cosi, cosi, 1.0f);
    const bool d2l = out2in ? ri > in_ri : ri > out_ri;
    is_tir = is_refr && d2l && (sin2t > 1.0f);
    const V3 u_tir = fmas(neg(N2), 2.0f * cosi, u);
    const V3 O_tir = fmas(N2, eps, P);
    const V3 w = fmas(neg(N2), cosi, u);
    const V3 u_ref = fmas(N2, -sqrt32(clamp_min0(1.0f - sin2t)),
                          V3{w.x * ratio, w.y * ratio, w.z * ratio});
    const V3 O_ref = fmas(neg(N2), eps, P);
    const float ri_ref = out2in ? in_ri : out_ri;
    // ---- diffuse ----
    const V3 L{*a.L[0], *a.L[1], *a.L[2]};
    const V3 P_adj = fmas(N, eps, P);
    const V3 Lv = sub(L, P_adj);
    const float lv2 = dot(Lv, Lv);
    const float lvn = sqrt32(lv2);
    const V3 LP = sub(L, P);
    const float lp2 = dot(LP, LP);
    const float ndwl = dot(N, divs(LP, sqrt32(lp2)));
    const float lum = *a.intensity / (kFourPi * lp2) * clamp_min0(ndwl);
    // ---- the next ray; misses keep theirs ----
    const bool not_tir = is_refr && !is_tir;
    V3 O2 = sel(is_mirror, O_mir, O), u2 = sel(is_mirror, u_mir, u);
    O2 = sel(is_tir, O_tir, sel(not_tir, O_ref, O2));
    u2 = sel(is_tir, u_tir, sel(not_tir, u_ref, u2));
    float ri2 = not_tir ? ri_ref : ri;
    O2 = sel(is_diff, P_adj, O2);
    ri2 = is_diff ? 1.0f : ri2;  // bounce rays reset the medium
    store3(a.O2, i, O2);
    store3(a.u2, i, u2);
    a.ri2[i] = ri2;
    store3(a.S, i, P_adj);
    store3(a.d, i, divs(Lv, lvn));
    a.cap[i] = lvn;
    a.lv2[i] = lv2;
    store3(a.N, i, N);
    store3(a.alb, i, V3{a.albedo[0][oid], a.albedo[1][oid],
                        a.albedo[2][oid]});
    a.lum[i] = lum * kInvPi;
    a.is_diff[i] = is_diff;
    a.sh_active[i] = is_diff && (ndwl > 0.0f);
  }
  count(hit, a.counts + 0);
  count(is_mirror, a.counts + 1);
  count(is_refr, a.counts + 2);
  count(is_tir, a.counts + 3);
  count(is_diff, a.counts + 4);
}

// ------------------------------------------------------------ rt_bounce

struct BounceArgs {
  const float* u2[3];    // rt_shade's next direction, N, albedo, lum / PI,
  const float* N[3];     // |Lv|^2 and masks
  const float* alb[3];
  const float* lum;
  const float* lv2;
  const bool* is_diff;
  const bool* sh_active;
  const float* t_sph;    // the shadow rays' sphere distance (or, for the
  const float* t_mesh;   // dense and bvh traversals, the whole query's) and
  const float* r1;       // the mesh's, or null; the bounce's two uniforms
  const float* r2;
  float* u3[3];          // the next direction
  float* direct[3];
  long long* counts;     // += shadowed
};

__global__ void __launch_bounds__(kThreads)
    bounce_kernel(BounceArgs a, int R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool in = i < R;
  bool shadowed = false;
  if (in) {
    const bool is_diff = a.is_diff[i];
    float t_sh = a.t_sph[i];
    if (a.t_mesh) t_sh = minimum(t_sh, a.t_mesh[i]);
    const bool occluded = t_sh * t_sh <= a.lv2[i];
    shadowed = a.sh_active[i] && occluded;
    const float w = (is_diff && !occluded) ? a.lum[i] : 0.0f;
    const V3 alb = load3(a.alb, i);
    store3(a.direct, i, V3{alb.x * w, alb.y * w, alb.z * w});
    // ---- cosine_hemisphere(r1, r2, N) ----
    const V3 N = load3(a.N, i);
    const float r1 = a.r1[i], r2 = a.r2[i];
    const float phi = kTwoPi * r1;
    const float s1 = sqrt32(1.0f - r2);
    const float x = cos32(phi) * s1, y = sin32(phi) * s1, z = sqrt32(r2);
    const bool cond = (fabsf(N.y) != 0.0f) && (fabsf(N.x) != 0.0f);
    V3 t1 = cond ? V3{-N.y, N.x, 0.0f} : V3{-N.z, 0.0f, N.x};
    t1 = divs(t1, norm(t1));
    const V3 t2 = cross(N, t1);
    const V3 u_dif = fmas(N, z, V3{fma64(t1.x, x, t2.x * y),
                                   fma64(t1.y, x, t2.y * y),
                                   fma64(t1.z, x, t2.z * y)});
    store3(a.u3, i, sel(is_diff, u_dif, load3(a.u2, i)));
  }
  count(shadowed, a.counts + 5);
}

// ------------------------------------------------------------ rt_primary_rays

__device__ __forceinline__ uint32_t rotl(uint32_t v, int d) {
  return (v << d) | (v >> (32 - d));
}

// threefry2x32, 20 rounds, of the counter (x0, x1) under (k0, k1)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int r = 0; r < 5; ++r) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[r % 2][j]) ^ x0;
    }
    x0 += ks[(r + 1) % 3];
    x1 += ks[(r + 2) % 3] + static_cast<uint32_t>(r + 1);
  }
}

// uniform_open0 of the partitionable random bits of counter n
__device__ __forceinline__ float uniform_open0(uint32_t k0, uint32_t k1,
                                               uint64_t n) {
  uint32_t y0 = static_cast<uint32_t>(n >> 32), y1 = static_cast<uint32_t>(n);
  threefry(k0, k1, y0, y1);
  const uint32_t bits = y0 ^ y1;
  const float one_two = __uint_as_float((bits >> 9) | 0x3F800000u);
  return 1.0f - (one_two - 1.0f);
}

// core/vec.log: Cephes logf with its multiply-adds as XLA:CPU fuses them
__device__ float cephes_log(float xin) {
  const int bits = __float_as_int(xin);
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  float e = static_cast<float>((bits >> 23) - 0x7F) + 1.0f;
  const bool small = m < static_cast<float>(0.707106781186547524);
  float x = (m - 1.0f) + (small ? m : 0.0f);
  e = e - (small ? 1.0f : 0.0f);
  const float x2 = x * x;
  const float x3 = x2 * x;
  const float p[9] = {
      static_cast<float>(7.0376836292e-2), static_cast<float>(-1.1514610310e-1),
      static_cast<float>(1.1676998740e-1), static_cast<float>(-1.2420140846e-1),
      static_cast<float>(1.4249322787e-1), static_cast<float>(-1.6668057665e-1),
      static_cast<float>(2.0000714765e-1), static_cast<float>(-2.4999993993e-1),
      static_cast<float>(3.3333331174e-1)};
  const float y0 = fma64(fma64(p[0], x, p[1]), x, p[2]);
  const float y1 = fma64(fma64(p[3], x, p[4]), x, p[5]);
  const float y2 = fma64(fma64(p[6], x, p[7]), x, p[8]);
  float y = fma64(fma64(y0, x3, y1), x3, y2);
  y = fma64(y, x3, e * static_cast<float>(-2.12194440e-4));
  x = fma64(x2, -0.5f, x) + y;
  return fma64(e, static_cast<float>(0.693359375), x);
}

struct PrimaryArgs {
  const long long* key[2];  // the frame key's words (0-d int64)
  const long long* rows;    // (nr,) global row ids
  const float* C[3];        // the camera (0-d each)
  const float* bx[3];
  const float* by[3];
  const float* bz[3];
  float* O[3];              // (nr * W,) this sample's rays
  float* u[3];
  float* un;                // uniforms (D, 2, .) of depths 1..D, rows of
  long long un_stride;      // un_stride floats
  unsigned sample;
  int W, D, quirk;
  float sigma, half_w, half_h, z;
};

__global__ void __launch_bounds__(kThreads)
    primary_kernel(PrimaryArgs a, int R) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= R) return;
  const int r = i / a.W, x = i - r * a.W;
  const long long row = a.rows[r];
  // fold_in(key, sample), then fold_in(key_s, row): the counter (0, data)
  uint32_t s0 = 0, s1 = a.sample;
  threefry(static_cast<uint32_t>(*a.key[0]), static_cast<uint32_t>(*a.key[1]),
           s0, s1);
  uint32_t k0 = 0, k1 = static_cast<uint32_t>(row);
  threefry(s0, s1, k0, k1);
  // row_uniforms: element (d, j, x) of the row's (D + 1, 2, W) draw
  const uint64_t W = static_cast<uint64_t>(a.W);
  const float r1 = uniform_open0(k0, k1, x);
  const float r2 = uniform_open0(k0, k1, W + x);
  for (int d = 1; d <= a.D; ++d)
    for (int j = 0; j < 2; ++j)
      a.un[((d - 1) * 2 + j) * a.un_stride + i] =
          uniform_open0(k0, k1, (2 * d + j) * W + x);
  // box_muller_terms
  const float mag = a.sigma * sqrt32(-2.0f * cephes_log(r1));
  const float c = cos32(kTwoPi * r2), s = sin32(kTwoPi * r2);
  // pixel_centers and raygen
  const float ux = (static_cast<float>(x) - a.half_w) + 0.5f;
  const float uy = (a.half_h - static_cast<float>(row)) - 0.5f;
  const V3 C{*a.C[0], *a.C[1], *a.C[2]};
  const V3 bx{*a.bx[0], *a.bx[1], *a.bx[2]};
  const V3 by{*a.by[0], *a.by[1], *a.by[2]};
  const V3 bz{*a.bz[0], *a.bz[1], *a.bz[2]};
  V3 d;
  if (a.quirk) {
    d = V3{fma64(bx.x, ux, C.x + bz.x * a.z) + by.x * uy,
           fma64(bx.y, ux, C.y + bz.y * a.z) + by.y * uy,
           fma64(bx.z, ux, C.z + bz.z * a.z) + by.z * uy};
    d = V3{fma64(mag, c, d.x), fma64(mag, s, d.y), d.z};
  } else {
    const float gx = fma64(mag, c, ux), gy = fma64(mag, s, uy);
    d = V3{bx.x * gx + by.x * gy + bz.x * a.z,
           bx.y * gx + by.y * gy + bz.y * a.z,
           bx.z * gx + by.z * gy + bz.z * a.z};
  }
  store3(a.O, i, C);
  store3(a.u, i, divs(d, norm(d)));
}

int grid(int R) { return (R + kThreads - 1) / kThreads; }

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

// Each C function takes its tensors as one array of device pointers, in the
// order of the fields of its argument struct (ops/_kernels.py builds it),
// launches on `stream` and returns the launch's CUDA error (0 on success).
extern "C" {

// p: O(3), u(3), centres(3), radius, active, lv2, t, obj, N(3), active_out
// (full: active, lv2 and active_out null; else obj and N null)
int rt_sphere_hit(void* const* p, int R, int S, int full, void* stream) {
  SphereArgs a{};
  int k = 0;
  take(a.O, p, k);
  take(a.u, p, k);
  take(a.c, p, k);
  take(a.radius, p, k);
  take(a.active, p, k);
  take(a.lv2, p, k);
  take(a.t, p, k);
  take(a.obj, p, k);
  take(a.N, p, k);
  take(a.active_out, p, k);
  a.S = S;
  auto st = static_cast<cudaStream_t>(stream);
  if (full)
    sphere_kernel<true><<<grid(R), kThreads, 0, st>>>(a, R);
  else
    sphere_kernel<false><<<grid(R), kThreads, 0, st>>>(a, R);
  return finish();
}

// counts: n_counts zeroed 64-bit words on the card, n_counts
// kIdentityCounts
int rt_f32_identities(unsigned long long first, unsigned long long n,
                      unsigned long long* counts, int n_counts,
                      void* stream) {
  if (n_counts != kIdentityCounts) return cudaErrorInvalidValue;
  identities_kernel<<<132 * 8, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(first, n, counts);
  return finish();
}

// p: the fields of ShadeArgs from O to counts, in order (tm and Nm null
// without a mesh)
int rt_shade(void* const* p, int R, int mesh_id, float eps, void* stream) {
  ShadeArgs a{};
  int k = 0;
  take(a.O, p, k);
  take(a.u, p, k);
  take(a.ri, p, k);
  take(a.ts, p, k);
  take(a.obj, p, k);
  take(a.Ns, p, k);
  take(a.tm, p, k);
  take(a.Nm, p, k);
  take(a.albedo, p, k);
  take(a.mirror, p, k);
  take(a.in_ri, p, k);
  take(a.out_ri, p, k);
  take(a.L, p, k);
  take(a.intensity, p, k);
  take(a.O2, p, k);
  take(a.u2, p, k);
  take(a.ri2, p, k);
  take(a.S, p, k);
  take(a.d, p, k);
  take(a.cap, p, k);
  take(a.lv2, p, k);
  take(a.N, p, k);
  take(a.alb, p, k);
  take(a.lum, p, k);
  take(a.is_diff, p, k);
  take(a.sh_active, p, k);
  take(a.counts, p, k);
  a.mesh_id = mesh_id;
  a.eps = eps;
  shade_kernel<<<grid(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, R);
  return finish();
}

// p: the fields of BounceArgs in order (t_mesh null when there is none)
int rt_bounce(void* const* p, int R, void* stream) {
  BounceArgs a{};
  int k = 0;
  take(a.u2, p, k);
  take(a.N, p, k);
  take(a.alb, p, k);
  take(a.lum, p, k);
  take(a.lv2, p, k);
  take(a.is_diff, p, k);
  take(a.sh_active, p, k);
  take(a.t_sph, p, k);
  take(a.t_mesh, p, k);
  take(a.r1, p, k);
  take(a.r2, p, k);
  take(a.u3, p, k);
  take(a.direct, p, k);
  take(a.counts, p, k);
  bounce_kernel<<<grid(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, R);
  return finish();
}

// p: key(2), rows, C(3), bx(3), by(3), bz(3), O(3), u(3), un
int rt_primary_rays(void* const* p, int R, unsigned sample, int W, int D,
                    int quirk, long long un_stride, float sigma, float half_w,
                    float half_h, float z, void* stream) {
  PrimaryArgs a{};
  int k = 0;
  take(a.key, p, k);
  take(a.rows, p, k);
  take(a.C, p, k);
  take(a.bx, p, k);
  take(a.by, p, k);
  take(a.bz, p, k);
  take(a.O, p, k);
  take(a.u, p, k);
  take(a.un, p, k);
  a.un_stride = un_stride;
  a.sample = sample;
  a.W = W;
  a.D = D;
  a.quirk = quirk;
  a.sigma = sigma;
  a.half_w = half_w;
  a.half_h = half_h;
  a.z = z;
  primary_kernel<<<grid(R), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, R);
  return finish();
}

}  // extern "C"
