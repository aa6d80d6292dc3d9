// Culling kernels of the pairs traversal for Hopper (sm_90a).
//
// Replace XLA-side work of the JAX package (it has no Pallas kernel for
// either; ops/pairs_trace.py's plain versions are their contracts):
//   rt_pair_bits    raytracinggpu_tpu/ops/pairs_trace.py::_pair_bits with
//                   members: the per-subgroup active-tile bitmask
//                   (port: pair_bits_plain);
//   rt_compact_key  raytracinggpu_tpu/ops/pairs_trace.py::_compact_key: the
//                   compaction ladder's sort key and active count
//                   (port: compact_key_plain).
// Both run the slab test of ops/pallas_trace.py::slab_enter_exit.
//
// Contract:
//   O, u   six (R,) f32 rows (origin, direction); cap (R,) f32 or null;
//          active (R,) bool (one byte) or null.
//   A ray hits box b when, with rc = 1 / u per axis and enter = -3.4e38,
//   exit = 3.4e38 folded over x, y, z in order,
//     t0 = (lo - O) * rc, t1 = (hi - O) * rc,
//     enter = max(enter, min(t0, t1)), exit = min(exit, max(t0, t1)),
//   exit >= enter, exit >= 0, enter <= cap (where given) and active
//   (where given).  min and max propagate NaN as torch.minimum and
//   torch.maximum do: a zero direction component gives rc = +-inf and
//   (lo - O) * inf is NaN where lo == O, and that ray misses the box.
//   CUDA's fminf / fmaxf drop NaN, so they are not used.
//   rt_pair_bits: bits (W, R / subg) i32, W = ceil(nc / 32); bit j of word
//     (w, sg) is set iff some ray of subgroup sg hits some member box whose
//     tile (member_tile) is 32w + j.  Members naming a tile outside [0, nc)
//     are ignored.
//   rt_compact_key: per ray the first and last of the nc key boxes it hits;
//     the lane is active when it hits one and lane < valid_n; key mode 2
//     first * (nc + 1) + last, else first; an inactive lane gets (nc + 1)^2
//     - 1 (mode 2) or nc; skey = (key << shift) | lane (int32, wrapping as
//     torch's int32 ops wrap); n_act (int64) the active lanes.
//
// Numerics: every product is (box - O) * rc, rounded alone (--fmad=false),
// and rc the IEEE reciprocal, so each slab test is the plain version's bit
// for bit; the OR, the any-reduce and first / last do not depend on the
// order the boxes and rays are visited in.
//
// What bounds it on this card: operations (about 24 f32 operations a
// slab test; the cat's depth-1 cast is 524,288 rays x 62 member boxes,
// and the rays' 28 bytes each are read once).  The design is the simple
// one: one thread a ray, the boxes staged through shared memory in chunks
// of kBoxChunk (each box a broadcast read), the reciprocal once a ray and
// axis.  rt_pair_bits gives each block whole subgroups: a warp's ballot
// and the first lane of each subgroup's run in the warp OR the tile bit
// into the block's words in shared memory (one atomic a run and box hit),
// and the words are stored once at the end, in passes of kWordSlots words
// when the table has more tiles.  rt_compact_key counts the active lanes
// with __syncthreads_count and one 64-bit atomic add a block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // rays a block, one a thread
constexpr int kBoxChunk = 256;    // boxes staged in shared memory at a time
constexpr int kWordSlots = 4096;  // bitmask words a pass of a block holds
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;

// torch.minimum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct SlabRay {
  float o[3], rc[3], cap;
  bool on;
};

struct RayRows {
  const float *ox, *oy, *oz, *ux, *uy, *uz, *cap;
  const unsigned char* active;
};

__device__ __forceinline__ SlabRay load_ray(const RayRows& in, int r,
                                            bool live) {
  SlabRay q;
  if (!live) {
    q.o[0] = q.o[1] = q.o[2] = 0.0f;
    q.rc[0] = q.rc[1] = q.rc[2] = 1.0f;
    q.cap = 0.0f;
    q.on = false;
    return q;
  }
  q.o[0] = in.ox[r];
  q.o[1] = in.oy[r];
  q.o[2] = in.oz[r];
  q.rc[0] = 1.0f / in.ux[r];
  q.rc[1] = 1.0f / in.uy[r];
  q.rc[2] = 1.0f / in.uz[r];
  // no cap: +inf, which every enter that can hit (exit <= 3.4e38) passes
  q.cap = in.cap ? in.cap[r] : __int_as_float(0x7f800000);
  q.on = in.active ? in.active[r] != 0 : true;
  return q;
}

// box: lo.xyz, hi.xyz
__device__ __forceinline__ bool slab_hit(const SlabRay& q, const float* box) {
  float enter = -kBig, exit = kBig;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (box[a] - q.o[a]) * q.rc[a];
    const float t1 = (box[3 + a] - q.o[a]) * q.rc[a];
    enter = max_nan(enter, min_nan(t0, t1));
    exit = min_nan(exit, max_nan(t0, t1));
  }
  return exit >= enter && exit >= 0.0f && enter <= q.cap && q.on;
}

// Stage boxes [m0, m0 + n) of the (nb, ld) rows into shared memory (and
// their tiles, when given); the block waits before and after.
__device__ __forceinline__ void stage_boxes(float (*sbox)[6], int* stile,
                                            const float* boxes, int ld,
                                            const int* tiles, int m0, int n) {
  __syncthreads();  // the previous chunk is consumed
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float* b = boxes + static_cast<long long>(m0 + j) * ld;
#pragma unroll
    for (int c = 0; c < 6; ++c) sbox[j][c] = b[c];
    if (tiles) stile[j] = tiles[m0 + j];
  }
  __syncthreads();
}

// Block b owns subgroups [b * G, b * G + G) (rays of whole subgroups, in
// passes of kThreads when a subgroup is wider than the block) and builds
// their words in shared memory, Wc words a subgroup at a time.
__global__ void __launch_bounds__(kThreads)
pair_bits_kernel(RayRows in, const float* __restrict__ boxes, int ld,
                 const int* __restrict__ member_tile, int nm, int R, int subg,
                 int nc, int W, int G, int Wc, int* __restrict__ bits) {
  __shared__ unsigned words[kWordSlots];
  __shared__ float sbox[kBoxChunk][6];
  __shared__ int stile[kBoxChunk];

  const int S = R / subg;
  const int sg0 = blockIdx.x * G;
  const int n_sg = min(G, S - sg0);
  const int n_rays = n_sg * subg;
  const int lane = threadIdx.x & 31;

  for (int w0 = 0; w0 < W; w0 += Wc) {
    const int nw = min(Wc, W - w0);
    for (int i = threadIdx.x; i < nw * n_sg; i += kThreads) words[i] = 0u;
    for (int base = 0; base < n_rays; base += kThreads) {
      const int i = base + threadIdx.x;
      const bool live = i < n_rays;
      const SlabRay q = load_ray(in, sg0 * subg + i, live);
      // the first lane of each subgroup's run in this warp ORs for the run
      const int sg = live ? i / subg : -1;
      const int prev = __shfl_up_sync(kFull, sg, 1);
      const bool leader = live && (lane == 0 || prev != sg);
      const unsigned leaders = __ballot_sync(kFull, leader);
      const unsigned above = lane == 31 ? 0u : leaders & (kFull << (lane + 1));
      const int end = above ? __ffs(static_cast<int>(above)) - 1 : 32;
      const unsigned run =
          (end == 32 ? kFull : (1u << end) - 1u) & (kFull << lane);
      for (int m0 = 0; m0 < nm; m0 += kBoxChunk) {
        const int n = min(kBoxChunk, nm - m0);
        stage_boxes(sbox, stile, boxes, ld, member_tile, m0, n);
        for (int j = 0; j < n; ++j) {
          const int tile = stile[j];  // block-uniform: so is the skip
          const int t = tile - 32 * w0;
          if (tile < 0 || tile >= nc || t < 0 || t >= 32 * nw) continue;
          const unsigned hits = __ballot_sync(kFull, slab_hit(q, sbox[j]));
          if (leader && (hits & run))
            atomicOr(&words[(t >> 5) * n_sg + sg], 1u << (t & 31));
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nw * n_sg; i += kThreads)
      bits[static_cast<long long>(w0 + i / n_sg) * S + sg0 + i % n_sg] =
          static_cast<int>(words[i]);
    __syncthreads();  // the words are free for the next pass
  }
}

__global__ void __launch_bounds__(kThreads)
compact_key_kernel(RayRows in, const float* __restrict__ boxes, int ld, int nc,
                   int mode, int shift, int R, int valid_n,
                   int* __restrict__ skey,
                   unsigned long long* __restrict__ n_act) {
  __shared__ float sbox[kBoxChunk][6];

  const int r = blockIdx.x * kThreads + threadIdx.x;
  const bool live = r < R;
  const SlabRay q = load_ray(in, r, live);
  int first = nc, last = -1;
  for (int m0 = 0; m0 < nc; m0 += kBoxChunk) {
    const int n = min(kBoxChunk, nc - m0);
    stage_boxes(sbox, nullptr, boxes, ld, nullptr, m0, n);
    for (int j = 0; j < n; ++j) {
      if (slab_hit(q, sbox[j])) {  // ascending boxes: first once, last max
        if (first == nc) first = m0 + j;
        last = m0 + j;
      }
    }
  }
  const bool act = live && last >= 0 && r < valid_n;
  const unsigned n1 = static_cast<unsigned>(nc) + 1u;
  unsigned key;
  if (mode == 2)
    key = act ? static_cast<unsigned>(first) * n1 + static_cast<unsigned>(last)
              : n1 * n1 - 1u;
  else
    key = static_cast<unsigned>(act ? first : nc);
  if (live)
    skey[r] = static_cast<int>((key << shift) | static_cast<unsigned>(r));
  const int n = __syncthreads_count(act);
  if (threadIdx.x == 0 && n) atomicAdd(n_act, static_cast<unsigned long long>(n));
}

}  // namespace

extern "C" {

int rt_pair_bits(const float* ox, const float* oy, const float* oz,
                 const float* ux, const float* uy, const float* uz,
                 const float* boxes, int ld, const int* member_tile, int nm,
                 const float* cap, const unsigned char* active, int R,
                 int subg, int nc, int* bits, void* stream) {
  if (R <= 0 || subg <= 0 || R % subg || nc <= 0 || ld < 6 || nm < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = R / subg;
  const int W = (nc + 31) / 32;
  const int G = subg >= kThreads ? 1 : kThreads / subg;
  const int Wc = kWordSlots / G;
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, active};
  pair_bits_kernel<<<(S + G - 1) / G, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      in, boxes, ld, member_tile, nm, R, subg, nc, W, G, Wc, bits);
  return static_cast<int>(cudaGetLastError());
}

int rt_compact_key(const float* ox, const float* oy, const float* oz,
                   const float* ux, const float* uy, const float* uz,
                   const float* boxes, int ld, int nc, int mode, int shift,
                   const float* cap, const unsigned char* active, int R,
                   int valid_n, int* skey, long long* n_act, void* stream) {
  if (R <= 0 || nc < 0 || ld < 6 || shift < 0 || shift > 31)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(n_act, 0, sizeof(long long), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, active};
  compact_key_kernel<<<(R + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      in, boxes, ld, nc, mode, shift, R, valid_n, skey,
      reinterpret_cast<unsigned long long*>(n_act));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
