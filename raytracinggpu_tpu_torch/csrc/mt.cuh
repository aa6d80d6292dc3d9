// The factorized Moller-Trumbore test every mesh kernel runs per (ray,
// triangle): pairs_trace.cu (B0-B3), pallas_trace.cu (B5, B6) and the
// probes of micro_kernel.cu (B7a, B7c, B7e).
//
// A ray is the feature rows [u, w = O x u, O] (rows 0-8 of rfT, (16, R)
// f32); a triangle is 16 field rows [Ng, e2 x A, e2, e1 x A, e1, A.Ng],
// staged in shared memory (stage.cuh):
//   denom = u.Ng;  beta = (u.(e2 x A) - w.e2) / denom;
//   gamma = (w.e1 - u.(e1 x A)) / denom;  t = (A.Ng - O.Ng) / denom,
// each division a multiply by rden = 1/denom, every sum left to right, in
// the order of the plain version (ops/pallas_trace.py::mt_slots).  The
// triangle is hit when denom != 0, min(beta, gamma, alpha) >= 0 with
// alpha = 1 - beta - gamma, and t > eps.  The barycentric test is a
// conjunction of >= comparisons, false on NaN as the plain version's
// NaN-propagating min is (fminf would drop it).  Built with --fmad=false
// and IEEE division, every product and sum rounds as PyTorch's eager ops
// round it.

#pragma once

namespace {

constexpr float kInf = 1e9f;  // 1e9+9 rounded to f32: a miss

struct Ray {
  float ux, uy, uz, wx, wy, wz, ox, oy, oz;
};

struct MTHit {
  float t, beta, gamma, alpha;
  float n0, n1, n2;  // the triangle's Ng, as loaded for the test
  bool valid;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rfT, int R,
                                        int r) {
  return {rfT[r],         rfT[R + r],     rfT[2 * R + r],
          rfT[3 * R + r], rfT[4 * R + r], rfT[5 * R + r],
          rfT[6 * R + r], rfT[7 * R + r], rfT[8 * R + r]};
}

// The test on one slot whose field row i is f(i): every kernel reads a
// slot staged in shared memory (stage.cuh) as four 16-byte loads.  The
// arithmetic below is the whole test.
template <class Field>
__device__ __forceinline__ MTHit mt_eval(const Ray& q, Field f, float eps) {
  const float n0 = f(0), n1 = f(1), n2 = f(2);
  const float denom = q.ux * n0 + q.uy * n1 + q.uz * n2;
  const float bnum = (q.ux * f(3) + q.uy * f(4) + q.uz * f(5)) -
                     (q.wx * f(6) + q.wy * f(7) + q.wz * f(8));
  const float gnum = (q.wx * f(12) + q.wy * f(13) + q.wz * f(14)) -
                     (q.ux * f(9) + q.uy * f(10) + q.uz * f(11));
  const float tnum = f(15) - (q.ox * n0 + q.oy * n1 + q.oz * n2);
  const float rden = 1.0f / denom;
  const float beta = bnum * rden;
  const float gamma = gnum * rden;
  const float tval = tnum * rden;
  const float alpha = 1.0f - beta - gamma;
  const bool valid = denom != 0.0f && beta >= 0.0f && gamma >= 0.0f &&
                     alpha >= 0.0f && tval > eps;
  return {tval, beta, gamma, alpha, n0, n1, n2, valid};
}

}  // namespace
