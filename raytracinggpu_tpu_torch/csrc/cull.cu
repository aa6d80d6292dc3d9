// Culling kernels of the pairs and tiled traversals for Hopper (sm_90a).
//
// Replace XLA-side work of the JAX package (it has no Pallas kernel for
// any; the port's plain versions are their contracts):
//   rt_pair_bits    raytracinggpu_tpu/ops/pairs_trace.py::_pair_bits with
//                   members: the per-subgroup active-tile bitmask
//                   (port: ops/pairs_trace.py::pair_bits_plain);
//   rt_compact_bits the same on a compacted cast's C rays, with their
//                   rows: _compact_sort's lanes, the jnp.take of the live
//                   rows and _pair_bits on the rays they hold (port:
//                   ops/pairs_trace.py::compact_bits_plain);
//   rt_compact_key  raytracinggpu_tpu/ops/pairs_trace.py::_compact_key: the
//                   compaction ladder's sort key and active count
//                   (port: ops/pairs_trace.py::compact_key_plain);
//   rt_tile_lists   raytracinggpu_tpu/ops/pallas_trace.py::
//                   _block_active_tiles: the tiled traversal's
//                   per-subgroup list rows for B5 and B6
//                   (port: ops/pallas_trace.py::block_active_tiles_plain).
// All run the slab test of ops/pallas_trace.py::slab_enter_exit.
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
//   rt_tile_lists: lists (R / subg, 1 + nc) i32, a row per subgroup:
//     [count, the active tiles ascending, the inactive tiles ascending],
//     tile t (box t of the nc) active for the subgroup iff some ray of it
//     hits the box and the box is valid, lo.x <= hi.x (false on NaN: the
//     inverted box of a padding tile, which the slab test would hit, is
//     culled so); bits (W, R / subg) i32 is its scratch where it runs in
//     two launches, rt_pair_bits' words with every valid tile its own
//     member.
//   rt_compact_bits: C rays, ray i the lane keys[i] & mask of the Rp rays'
//     rows (the sorted keys); rows (9-11, C) f32 the live rows of those
//     lanes (u, w = O x u rounded as glue.cu's rt_ray_rows rounds it, O;
//     cap, or a zero row, and the mask as 1.0 / 0.0 with active; cap alone
//     without), active_out (C,) their mask, and bits rt_pair_bits' on
//     those rays (O, u, cap where given, the mask where given).
//   rt_compact_key: per ray the first and last of the nc key boxes it hits;
//     the lane is active when it hits one and lane < valid_n; key mode 2
//     first * (nc + 1) + last, else first; an inactive lane gets (nc + 1)^2
//     - 1 (mode 2) or nc; skey = (key << shift) | lane (int32, wrapping as
//     torch's int32 ops wrap); n_act (int64) the active lanes.
//
// Numerics: every product is (box - O) * rc, rounded alone (--fmad=false),
// and rc the IEEE reciprocal, so each t0 and t1 is the plain version's bit
// for bit.  The test is then rewritten without changing a result:
//   with e = max(n_x, n_y, n_z), x = min(f_x, f_y, f_z) (n = min(t0, t1),
//   f = max(t0, t1), NaN-propagating), enter = max(-3.4e38, e) and exit =
//   min(3.4e38, x), and the hit is
//     x >= 0 && x >= e && e <= capm,
//   capm = min(3.4e38, cap) where active and -3.4e38 <= cap, else NaN
//   (which no e passes), folded once a ray.  (A NaN in e or x misses both
//   ways; else exit >= 0 iff x >= 0, and then exit >= enter iff x >= e and
//   e <= 3.4e38, enter <= cap iff e <= cap and -3.4e38 <= cap.)  That is
//   10 min / max and 3 compares a test, not 12 and 3 and two ands.  min
//   and max are PTX min.NaN / max.NaN (one FMNMX each); only comparisons
//   read them, so which zero they return cannot change a bit.  The OR, the
//   any-reduce and first / last do not depend on the order the boxes and
//   rays are visited in.
//
// What bounds it on this card: operations (24 f32 operations a slab test
// as the plain version counts them, none of which can fuse into an FMA,
// so the floor is their issue at one a lane and cycle; the cat's depth-1
// cast is 524,288 rays x 62 member boxes, and the rays' 28 bytes each are
// read once; rt_tile_lists' pallas cast 524,288 rays x 31 valid tiles,
// its rows 4 (1 + nc) bytes a subgroup written once).  On sm_90 FMNMX
// issues at half FMUL's rate (bench/cull_design's probe: 59 and 110 a
// clock and SM), so a test's 10 min / max and 3 compares on that pipe are
// a floor that the 24 operations at one a cycle do not see.  The design:
//   - K rays a thread (rt_pair_bits 4, 2 or 1: a divisor of the subgroup;
//     rt_compact_key 2 or 1; halved while the grid would give the card
//     fewer than kMinBlocksPerSm blocks an SM), their origin, reciprocal
//     and folded cap in registers; blocks
//     of kThreads held to 64 registers a thread, so that an SM holds
//     kMinResident of them and the cat's and the soup's 1,024 blocks run
//     in one wave on 132 SMs;
//   - boxes staged through shared memory as 32-byte rows, kBoxChunk at a
//     time: two 16-byte broadcast loads a box feed K slab tests;
//   - the three compares of each of a thread's K rays chain through one
//     predicate (PTX setp with .and), never leaving it: no select a ray;
//   - rt_pair_bits stages only the members whose tile lies in [0, nc) and
//     in the current pass's words, compacted with a block-wide prefix, with
//     the tile's word slot and bit beside the box, so the inner loop has no
//     range test and no index math; a thread ORs its K rays' hits (all of
//     one subgroup, as K divides it), a warp runs one ballot a box, and the
//     first lane of each subgroup's run in the warp ORs the tile bit into
//     the block's words in shared memory with a predicated red (no branch;
//     a block owns whole subgroups, in passes of kThreads * K rays when a
//     subgroup is wider); the words are stored once at the end, in passes
//     of kWordSlots words when the table has more tiles;
//   - rt_compact_bits is rt_pair_bits' kernel with its ray load gathered:
//     a thread reads its K keys, then their lanes' rows; it stores the
//     rays' live rows (K columns a store) after the first staging of
//     boxes, so that the boxes' loads overlap the lanes' (key, then lanes
//     and boxes, then the tests: two memory round trips before the tests,
//     not three), and writes no source lanes (the scatter reads the keys);
//     one or two rays a thread (four spill past 64 registers);
//   - rt_tile_lists runs rt_pair_bits' kernel with no member array: member
//     m is tile m, staged when its box is valid, and each pass of words
//     stages only its own tiles' boxes.  Where one pass holds the block's
//     words (the cat's and the soup's casts), the same launch writes the
//     rows from the words in shared memory; else the words go to bits and
//     a second launch writes them, a warp a row.  Either way one warp a
//     subgroup expands its words into its row (emit_row): the count a popc
//     sum, then for each word the warp's lanes take its 32 tiles, an
//     active tile's slot 1 + the active tiles before it (a popc prefix), an
//     inactive one's 1 + count + the inactive tiles before it; no sort,
//     and a row's writes are two coalesced runs a word.  A row (up to 1 +
//     nc ints) never sits in shared memory, so any tile count works.  Over
//     a table of one staging chunk it takes at most two rays a thread: two
//     waves of blocks, one's ray loads under another's tests
//     (tile_lists_k);
//   - rt_compact_key ORs a ray's hits over 32 boxes into a mask, one
//     predicated or a test, and takes first and last from it; it counts its
//     active lanes in the same launch: each block adds its count to a
//     device counter and the last block to take a ticket moves the sum into
//     n_act and resets counter and ticket, so the next call (or graph
//     replay) starts from zero.  The counter is the module's, one a device:
//     calls on one device must not overlap on two streams (the port
//     launches on PyTorch's current stream).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;      // threads a block
constexpr int kWarps = kThreads / 32;
constexpr int kBoxChunk = kThreads;  // boxes staged at a time, one a thread
constexpr int kWordSlots = 4096;   // bitmask words a pass of a block holds
constexpr int kMinBlocksPerSm = 4;
constexpr int kMinResident = 8;  // blocks an SM holds: at most 64 registers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.4e38f;

// rt_compact_key's block counts and ticket (zero when no launch runs)
__device__ unsigned long long g_key_count;
__device__ unsigned g_key_ticket;

// torch.minimum / torch.maximum: NaN in either operand gives NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct __align__(16) Box {
  float4 lo, hi;  // rt_pair_bits: lo.w 4 x the tile's first word slot of
                  // the pass (bytes), hi.w the tile's bit
};

struct SlabRay {
  float o[3], rc[3];
  float capm;  // min(3.4e38, cap) where active and -3.4e38 <= cap, else NaN
};

struct RayRows {
  const float *ox, *oy, *oz, *ux, *uy, *uz, *cap;
  const unsigned char* active;
};

// rt_compact_bits: the cast's rays are lanes keys[i] & mask of the rows
// of RayRows; the live rows of ray i go to rows[k * C + i] (and active_out
// [i] with active)
struct Gather {
  const int* keys;
  float* rows;
  unsigned char* active_out;
  int mask, C;
};

// Vec3.cross's component on the card (csrc/glue.cu's fma64): the exact
// f64 product of a and b plus the f32 c, rounded once to f32
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return static_cast<float>(static_cast<double>(a) * static_cast<double>(b) +
                            static_cast<double>(c));
}

__device__ __forceinline__ SlabRay load_ray(const RayRows& in, int r,
                                            bool live) {
  SlabRay q;
  const float nan = __int_as_float(0x7fffffff);
  if (!live) {
    q.o[0] = q.o[1] = q.o[2] = 0.0f;
    q.rc[0] = q.rc[1] = q.rc[2] = 1.0f;
    q.capm = nan;
    return q;
  }
  q.o[0] = in.ox[r];
  q.o[1] = in.oy[r];
  q.o[2] = in.oz[r];
  q.rc[0] = 1.0f / in.ux[r];
  q.rc[1] = 1.0f / in.uy[r];
  q.rc[2] = 1.0f / in.uz[r];
  // no cap: +inf, which every enter that can hit (exit <= 3.4e38) passes
  const float cap = in.cap ? in.cap[r] : __int_as_float(0x7f800000);
  const bool on = (in.active ? in.active[r] != 0 : true) && -kBig <= cap;
  q.capm = on ? min_nan(kBig, cap) : nan;
  return q;
}

// K (1 or 2) consecutive floats at p (4 K-byte aligned: K divides the
// index and the row length) in one store
template <int K>
__device__ __forceinline__ void store_k(float* p, const float* v) {
  if (K == 2)
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else
    *p = v[0];
}

// What rt_compact_bits' rays hold besides their SlabRay until their rows
// are written: u, cap (0 without one) and the mask (1 without one).
template <int K>
struct Gathered {
  float u[3][K], cap[K];
  unsigned char act[K];
};

// rt_compact_bits' ray load: rays i .. i + K - 1 of the cast are the lanes
// of their sorted keys; all K keys are read before any lane, then the
// lanes' O, u (cap, active), as load_ray reads them at that lane, which is
// what the live rows hold (a copy, cap and the mask's 1.0 / 0.0 compare
// back to the same values).
template <int K>
__device__ __forceinline__ void gather_rays(const RayRows& in,
                                            const Gather& g, int i,
                                            bool live, SlabRay* q,
                                            Gathered<K>& raw) {
  if (!live) {
#pragma unroll
    for (int r = 0; r < K; ++r) q[r] = load_ray(in, 0, false);
    return;
  }
  int lane[K];
#pragma unroll
  for (int r = 0; r < K; ++r) lane[r] = __ldg(g.keys + i + r) & g.mask;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int l = lane[r];
    q[r].o[0] = in.ox[l];
    q[r].o[1] = in.oy[l];
    q[r].o[2] = in.oz[l];
    raw.u[0][r] = in.ux[l];
    raw.u[1][r] = in.uy[l];
    raw.u[2][r] = in.uz[l];
    raw.cap[r] = in.cap ? in.cap[l] : 0.0f;
    raw.act[r] = in.active ? (in.active[l] != 0) : 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) q[r].rc[a] = 1.0f / raw.u[a][r];
    const float c = in.cap ? raw.cap[r] : __int_as_float(0x7f800000);
    q[r].capm = raw.act[r] && -kBig <= c ? min_nan(kBig, c)
                                         : __int_as_float(0x7fffffff);
  }
}

// The live rows (ops/pairs_trace.py::compact_rows_plain) of rt_compact_bits'
// rays i .. i + K - 1, K columns a store: u, w = O x u (Vec3.cross, fma64),
// O, then cap (or a zero row) and the mask as 1.0 / 0.0 with active, cap
// alone without; and the mask at active_out[i ..].
template <int K>
__device__ __forceinline__ void write_rows(const RayRows& in,
                                           const Gather& g, int i,
                                           const SlabRay* q,
                                           const Gathered<K>& raw) {
  float* p = g.rows + i;
  const long long C = g.C;
  float v[K];
  auto row = [&](int k) { store_k<K>(p + k * C, v); };
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = raw.u[a][r];
    row(a);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int b = (a + 1) % 3, c = (a + 2) % 3;
#pragma unroll
    for (int r = 0; r < K; ++r)
      v[r] = fma64(q[r].o[b], raw.u[c][r], -(q[r].o[c] * raw.u[b][r]));
    row(3 + a);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = q[r].o[a];
    row(6 + a);
  }
  if (in.cap || in.active) {
#pragma unroll
    for (int r = 0; r < K; ++r) v[r] = raw.cap[r];
    row(9);
  }
  if (in.active) {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      v[r] = raw.act[r] ? 1.0f : 0.0f;
      g.active_out[i + r] = raw.act[r];
    }
    row(10);
  }
}

// The slab test's e = max(n_x, n_y, n_z) and x = min(f_x, f_y, f_z); the
// ray hits the box iff x >= 0 && x >= e && e <= capm (see the header).
__device__ __forceinline__ void slab(const SlabRay& q, const float4& lo,
                                     const float4& hi, float& e, float& x) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float t0 = (l[a] - q.o[a]) * q.rc[a];
    const float t1 = (h[a] - q.o[a]) * q.rc[a];
    const float n = min_nan(t0, t1), f = max_nan(t0, t1);
    e = a ? max_nan(e, n) : n;
    x = a ? min_nan(x, f) : f;
  }
}

// PTX: predicate P = the hit of the ray whose e, x, capm are operands E, X,
// C (three compares chained through the predicate, NaN-false)
#define RT_HIT(P, E, X, C)                                      \
  "setp.ge.f32 " P ", " X ", 0f00000000;\n\t"                   \
  "setp.ge.and.f32 " P ", " X ", " E ", " P ";\n\t"             \
  "setp.le.and.f32 " P ", " E ", " C ", " P ";\n\t"

// One box against a thread's K rays (e, x, c: their slab results and
// capm): the warp's ballot of "some of my rays hits", ANDed with the
// thread's run mask (0 unless it leads a run); where that is not zero the
// thread ORs ``bit`` into the shared word at ``addr``.  The predicates
// never leave the asm: no select a ray, no branch a box.
template <int K>
__device__ __forceinline__ void or_hits(const float* e, const float* x,
                                        const float* c, unsigned run,
                                        unsigned addr, unsigned bit);
template <>
__device__ __forceinline__ void or_hits<1>(const float* e, const float* x,
                                           const float* c, unsigned run,
                                           unsigned addr, unsigned bit) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t.reg .b32 h;\n\t" RT_HIT("p", "%0", "%1", "%2")
      "vote.sync.ballot.b32 h, p, 0xffffffff;\n\t"
      "and.b32 h, h, %3;\n\tsetp.ne.b32 p, h, 0;\n\t"
      "@p red.shared.or.b32 [%4], %5;\n\t}"
      ::"f"(e[0]), "f"(x[0]), "f"(c[0]), "r"(run), "r"(addr), "r"(bit));
}
template <>
__device__ __forceinline__ void or_hits<2>(const float* e, const float* x,
                                           const float* c, unsigned run,
                                           unsigned addr, unsigned bit) {
  asm volatile(
      "{\n\t.reg .pred p, q;\n\t.reg .b32 h;\n\t"
      RT_HIT("p", "%0", "%1", "%2") RT_HIT("q", "%3", "%4", "%5")
      "or.pred p, p, q;\n\t"
      "vote.sync.ballot.b32 h, p, 0xffffffff;\n\t"
      "and.b32 h, h, %6;\n\tsetp.ne.b32 p, h, 0;\n\t"
      "@p red.shared.or.b32 [%7], %8;\n\t}"
      ::"f"(e[0]), "f"(x[0]), "f"(c[0]), "f"(e[1]), "f"(x[1]), "f"(c[1]),
      "r"(run), "r"(addr), "r"(bit));
}
template <>
__device__ __forceinline__ void or_hits<4>(const float* e, const float* x,
                                           const float* c, unsigned run,
                                           unsigned addr, unsigned bit) {
  asm volatile(
      "{\n\t.reg .pred p, q, r, s;\n\t.reg .b32 h;\n\t"
      RT_HIT("p", "%0", "%1", "%2") RT_HIT("q", "%3", "%4", "%5")
      RT_HIT("r", "%6", "%7", "%8") RT_HIT("s", "%9", "%10", "%11")
      "or.pred p, p, q;\n\tor.pred r, r, s;\n\tor.pred p, p, r;\n\t"
      "vote.sync.ballot.b32 h, p, 0xffffffff;\n\t"
      "and.b32 h, h, %12;\n\tsetp.ne.b32 p, h, 0;\n\t"
      "@p red.shared.or.b32 [%13], %14;\n\t}"
      ::"f"(e[0]), "f"(x[0]), "f"(c[0]), "f"(e[1]), "f"(x[1]), "f"(c[1]),
      "f"(e[2]), "f"(x[2]), "f"(c[2]), "f"(e[3]), "f"(x[3]), "f"(c[3]),
      "r"(run), "r"(addr), "r"(bit));
}

// m |= bit where the ray (e, x, c) hits the box.
__device__ __forceinline__ void mark_hit(unsigned& m, float e, float x,
                                         float c, unsigned bit) {
  asm("{\n\t.reg .pred p;\n\t" RT_HIT("p", "%1", "%2", "%3")
      "@p or.b32 %0, %0, %4;\n\t}"
      : "+r"(m)
      : "f"(e), "f"(x), "f"(c), "r"(bit));
}

// Rays a thread: the largest of 4, 2, 1 dividing subg, halved while
// blocks(K) would give the card fewer than kMinBlocksPerSm blocks an SM;
// ``forced`` (1, 2 or 4) overrides.
template <typename Blocks>
int rays_per_thread(int subg, int forced, Blocks blocks) {
  if (forced == 1 || forced == 2 || forced == 4) return forced;
  static int sms[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) dev = 0;
  if (!sms[dev])
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  int k = subg % 4 == 0 ? 4 : subg % 2 == 0 ? 2 : 1;
  while (k > 1 && blocks(k) < static_cast<long long>(kMinBlocksPerSm) *
                                  (sms[dev] > 0 ? sms[dev] : 132))
    k /= 2;
  return k;
}

// Stage the members [m0, min(m0 + kBoxChunk, nm)) whose tile lies in
// [0, nc) and in [t0, t0 + nt), compacted to the front of sbox (lo.w 4 x
// the tile's word slot, (t - t0) / 32 x n_sg, hi.w its bit); returns how
// many.  With no member array (tiles null) member m is tile m, staged only
// when its box is valid (lo.x <= hi.x, false on NaN).  The block waits
// before and after.
__device__ __forceinline__ int stage_members(Box* sbox, int* warp_n,
                                             const float* boxes, int ld,
                                             const int* tiles, int m0, int nm,
                                             int nc, int t0, int nt,
                                             int n_sg) {
  __syncthreads();  // the previous chunk (and warp_n) is consumed
  const int m = m0 + static_cast<int>(threadIdx.x);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int t = 0;
  bool keep = false;
  if (m < nm) {
    const int tile = tiles ? tiles[m] : m;
    t = tile - t0;
    keep = tile >= 0 && tile < nc && t >= 0 && t < nt;
    if (!tiles && keep) {
      const float* b = boxes + static_cast<long long>(m) * ld;
      keep = b[0] <= b[3];
    }
  }
  const unsigned mask = __ballot_sync(kFull, keep);
  if (lane == 0) warp_n[warp] = __popc(mask);
  __syncthreads();
  int pos = __popc(mask & ((1u << lane) - 1u)), total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_n[w];
    pos += w < warp ? c : 0;
    total += c;
  }
  if (keep) {
    const float* b = boxes + static_cast<long long>(m) * ld;
    sbox[pos].lo = make_float4(b[0], b[1], b[2],
                               __int_as_float((t >> 5) * n_sg * 4));
    sbox[pos].hi = make_float4(b[3], b[4], b[5],
                               __uint_as_float(1u << (t & 31)));
  }
  __syncthreads();
  return total;
}

// The calling warp writes row s of lists (64-bit offsets) from the
// subgroup's words, word w at words[w * stride]: the count, then each
// word's 32 tiles, one a lane, an active tile at 1 + (active tiles before
// it), an inactive one at 1 + count + (inactive tiles before it).  A word
// has no bit at or past nc.
__device__ __forceinline__ void emit_row(const unsigned* words,
                                         long long stride, long long s,
                                         int W, int nc, int* lists) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int w = lane; w < W; w += 32) count += __popc(words[w * stride]);
  count = __reduce_add_sync(kFull, count);
  int* row = lists + s * (static_cast<long long>(nc) + 1);
  if (lane == 0) row[0] = count;
  const unsigned below = (1u << lane) - 1u;
  int before = 0;  // active tiles in the words before this one
  for (int w0 = 0; w0 < W; w0 += 32) {
    const unsigned mine = w0 + lane < W ? words[(w0 + lane) * stride] : 0u;
    const int nw = min(32, W - w0);
    for (int j = 0; j < nw; ++j) {
      const unsigned word = __shfl_sync(kFull, mine, j);
      const int tile = 32 * (w0 + j) + lane;
      const int on_before = before + __popc(word & below);
      if (tile < nc)
        row[1 + ((word >> lane) & 1u ? on_before
                                     : count + tile - on_before)] = tile;
      before += __popc(word);
    }
  }
}

// Block b owns subgroups [b * G, b * G + G) (rays of whole subgroups, in
// passes of kThreads * K when a subgroup is wider than that) and builds
// their words in shared memory, Wc words a subgroup at a time.  Thread t
// of a pass holds rays K t .. K t + K - 1, of one subgroup (K | subg).
// With member_tile null (rt_tile_lists) member m is tile m and a pass of
// words stages only the members of its own tiles.  kGather
// (rt_compact_bits): the R rays are gathered through g's sorted keys
// (gather_rays), and the first pass of words writes their live rows.
// kRows (rt_tile_lists in one launch, one pass of words): out is the list
// rows, each written from the words in shared memory (emit_row), a warp a
// subgroup; else out is the bits.
template <int K, bool kGather, bool kRows>
__global__ void __launch_bounds__(kThreads, kMinResident)
pair_bits_kernel(RayRows in, Gather g, const float* __restrict__ boxes,
                 int ld, const int* __restrict__ member_tile, int nm, int R,
                 int subg, int nc, int W, int G, int Wc,
                 int* __restrict__ out) {
  __shared__ unsigned words[kWordSlots];
  __shared__ Box sbox[kBoxChunk];
  __shared__ int warp_n[kWarps];

  const int S = R / subg;
  const int sg0 = blockIdx.x * G;
  const int n_sg = min(G, S - sg0);
  const int n_rays = n_sg * subg;
  const int lane = threadIdx.x & 31;

  for (int w0 = 0; w0 < W; w0 += Wc) {
    const int nw = min(Wc, W - w0);
    for (int i = threadIdx.x; i < nw * n_sg; i += kThreads) words[i] = 0u;
    for (int base = 0; base < n_rays; base += kThreads * K) {
      const int i0 = base + static_cast<int>(threadIdx.x) * K;
      const bool live = i0 < n_rays;  // K | n_rays: all K rays or none
      SlabRay q[K];
      Gathered<K> raw;
      // a gathered pass writes its rays' rows after its first staging, so
      // that the boxes' loads overlap the lanes'
      bool rows_due = kGather && live && w0 == 0;
      if (kGather) {
        gather_rays<K>(in, g, sg0 * subg + i0, live, q, raw);
      } else {
#pragma unroll
        for (int r = 0; r < K; ++r)
          q[r] = load_ray(in, sg0 * subg + i0 + r, live);
      }
      // the first lane of each subgroup's run in this warp ORs for the run
      const int sg = live ? i0 / subg : -1;
      const int prev = __shfl_up_sync(kFull, sg, 1);
      const bool leader = live && (lane == 0 || prev != sg);
      const unsigned leaders = __ballot_sync(kFull, leader);
      const unsigned above = lane == 31 ? 0u : leaders & (kFull << (lane + 1));
      const int end = above ? __ffs(static_cast<int>(above)) - 1 : 32;
      const unsigned run =
          (end == 32 ? kFull : (1u << end) - 1u) & (kFull << lane);
      const unsigned lead_run = leader ? run : 0u;
      // this thread's subgroup's word slot 0 (a shared-memory address)
      const unsigned sg_addr = static_cast<unsigned>(
          __cvta_generic_to_shared(&words[live ? sg : 0]));
      const int m_lo = member_tile ? 0 : 32 * w0;
      const int m_hi = member_tile ? nm : min(nm, 32 * (w0 + nw));
      for (int m0 = m_lo; m0 < m_hi; m0 += kBoxChunk) {
        const int n = stage_members(sbox, warp_n, boxes, ld, member_tile, m0,
                                    m_hi, nc, 32 * w0, 32 * nw, n_sg);
        if (kGather && rows_due) {
          write_rows<K>(in, g, sg0 * subg + i0, q, raw);
          rows_due = false;
        }
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
          const float4 lo = sbox[j].lo, hi = sbox[j].hi;
          float e[K], x[K], c[K];
#pragma unroll
          for (int r = 0; r < K; ++r) {
            slab(q[r], lo, hi, e[r], x[r]);
            c[r] = q[r].capm;
          }
          or_hits<K>(e, x, c, lead_run,
                     sg_addr + static_cast<unsigned>(__float_as_int(lo.w)),
                     __float_as_uint(hi.w));
        }
      }
      if (kGather && rows_due) write_rows<K>(in, g, sg0 * subg + i0, q, raw);
    }
    __syncthreads();
    if (kRows) {
      for (int s = threadIdx.x >> 5; s < n_sg; s += kWarps)
        emit_row(words + s, n_sg, sg0 + s, W, nc, out);
    } else {
      for (int i = threadIdx.x; i < nw * n_sg; i += kThreads)
        out[static_cast<long long>(w0 + i / n_sg) * S + sg0 + i % n_sg] =
            static_cast<int>(words[i]);
    }
    __syncthreads();  // the words are free for the next pass
  }
}

// rt_tile_lists' second launch: warp s of the grid writes subgroup s's row
// from the words pair_bits_kernel left in bits[w * S + s].
__global__ void __launch_bounds__(kThreads)
tile_lists_kernel(const unsigned* __restrict__ bits, int S, int W, int nc,
                  int* __restrict__ lists) {
  const long long s =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  if (s >= S) return;  // whole warps
  emit_row(bits + s, S, s, W, nc, lists);
}

// Thread t of block b holds rays K (b kThreads + t) .. + K - 1.
template <int K>
__global__ void __launch_bounds__(kThreads, kMinResident)
compact_key_kernel(RayRows in, const float* __restrict__ boxes, int ld, int nc,
                   int mode, int shift, int R, int valid_n,
                   int* __restrict__ skey,
                   unsigned long long* __restrict__ n_act) {
  __shared__ Box sbox[kBoxChunk];
  __shared__ int warp_n[kWarps];

  const int r0 = (blockIdx.x * kThreads + threadIdx.x) * K;
  SlabRay q[K];
  int first[K], last[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    q[r] = load_ray(in, r0 + r, r0 + r < R);
    first[r] = nc;
    last[r] = -1;
  }
  for (int m0 = 0; m0 < nc; m0 += kBoxChunk) {
    const int n = min(kBoxChunk, nc - m0);
    __syncthreads();  // the previous chunk is consumed
    if (static_cast<int>(threadIdx.x) < n) {
      const float* p = boxes + static_cast<long long>(m0 + threadIdx.x) * ld;
      sbox[threadIdx.x].lo = make_float4(p[0], p[1], p[2], 0.0f);
      sbox[threadIdx.x].hi = make_float4(p[3], p[4], p[5], 0.0f);
    }
    __syncthreads();
    for (int j0 = 0; j0 < n; j0 += 32) {
      const int nj = min(32, n - j0);
      unsigned hit[K];
#pragma unroll
      for (int r = 0; r < K; ++r) hit[r] = 0u;
#pragma unroll 4
      for (int j = 0; j < nj; ++j) {
        const float4 lo = sbox[j0 + j].lo, hi = sbox[j0 + j].hi;
        const unsigned bit = 1u << j;
#pragma unroll
        for (int r = 0; r < K; ++r) {
          float e, x;
          slab(q[r], lo, hi, e, x);
          mark_hit(hit[r], e, x, q[r].capm, bit);
        }
      }
#pragma unroll
      for (int r = 0; r < K; ++r) {
        if (hit[r]) {  // ascending boxes: first once, last the highest
          if (first[r] == nc) first[r] = m0 + j0 + __ffs(hit[r]) - 1;
          last[r] = m0 + j0 + 31 - __clz(hit[r]);
        }
      }
    }
  }
  const unsigned n1 = static_cast<unsigned>(nc) + 1u;
  int n_on = 0;
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int lane_id = r0 + r;
    if (lane_id >= R) break;
    const bool act = last[r] >= 0 && lane_id < valid_n;
    unsigned key;
    if (mode == 2)
      key = act ? static_cast<unsigned>(first[r]) * n1 +
                      static_cast<unsigned>(last[r])
                : n1 * n1 - 1u;
    else
      key = static_cast<unsigned>(act ? first[r] : nc);
    skey[lane_id] =
        static_cast<int>((key << shift) | static_cast<unsigned>(lane_id));
    n_on += act;
  }
  n_on = __reduce_add_sync(kFull, n_on);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = n_on;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += static_cast<unsigned>(warp_n[w]);
    if (n) atomicAdd(&g_key_count, n);
    __threadfence();  // the count lands before the ticket
    if (atomicAdd(&g_key_ticket, 1u) == gridDim.x - 1) {
      __threadfence();
      *n_act = atomicExch(&g_key_count, 0ull);
      atomicExch(&g_key_ticket, 0u);
    }
  }
}

// Subgroups a block of pair_bits_kernel<K> holds
int group_of(int subg, int K) {
  return subg >= kThreads * K ? 1 : kThreads * K / subg;
}

template <int K, bool kGather = false, bool kRows = false>
cudaError_t launch_pair_bits(const RayRows& in, const float* boxes, int ld,
                             const int* member_tile, int nm, int R, int subg,
                             int nc, int* out, cudaStream_t st,
                             const Gather& g = Gather{}) {
  const int S = R / subg;
  const int W = (nc + 31) / 32;
  const int G = group_of(subg, K);
  const int Wc = kWordSlots / G;
  pair_bits_kernel<K, kGather, kRows><<<(S + G - 1) / G, kThreads, 0, st>>>(
      in, g, boxes, ld, member_tile, nm, R, subg, nc, W, G, Wc, out);
  return cudaGetLastError();
}

// The K of rt_pair_bits, rt_compact_bits and rt_tile_lists over R rays:
// rays_per_thread over their blocks (groups) of whole subgroups
int subgroup_k(int R, int subg, int forced) {
  const long long S = R / subg;
  return rays_per_thread(subg, forced, [&](int kk) {
    const long long G = group_of(subg, kk);
    return (S + G - 1) / G;
  });
}

// rt_tile_lists' rays a thread: subgroup_k's, but at most two over a
// table of one staging chunk (kBoxChunk tiles or fewer), where the tests
// are short and two waves of blocks put one's ray loads under another's
// tests (bench/cull_design: the cat's pallas cast 0.0285 ms at two, 0.0310
// at four); more tiles keep four (the soup's 0.9916 at four, 1.0927 at
// two).
int tile_lists_k(int R, int subg, int nc, int forced) {
  const int k = subgroup_k(R, subg, forced);
  return !forced && nc <= kBoxChunk && k > 2 ? 2 : k;
}

// Whether rt_tile_lists at K rays a thread runs in one launch: a block's
// subgroups' words in one pass
bool tile_lists_one(int subg, int nc, int K) {
  return static_cast<long long>((nc + 31) / 32) * group_of(subg, K) <=
         kWordSlots;
}

// rt_tile_lists: in one launch where it fits (tile_lists_one) and one is
// set, pair_bits_kernel writing the rows; else two: the words of every
// valid tile (pair_bits_kernel with no member array) into bits, then the
// rows (tile_lists_kernel).
template <int K>
cudaError_t launch_tile_lists(const RayRows& in, const float* boxes, int ld,
                              int R, int subg, int nc, int* bits, int* lists,
                              int one, cudaStream_t st) {
  if (one && tile_lists_one(subg, nc, K))
    return launch_pair_bits<K, false, true>(in, boxes, ld, nullptr, nc, R,
                                            subg, nc, lists, st);
  if (!bits) return cudaErrorInvalidValue;
  cudaError_t err = launch_pair_bits<K>(in, boxes, ld, nullptr, nc, R, subg,
                                        nc, bits, st);
  if (err != cudaSuccess) return err;
  const long long S = R / subg;
  const long long threads = S * 32;
  tile_lists_kernel<<<static_cast<int>((threads + kThreads - 1) / kThreads),
                      kThreads, 0, st>>>(
      reinterpret_cast<const unsigned*>(bits), static_cast<int>(S),
      (nc + 31) / 32, nc, lists);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_compact_key(const RayRows& in, const float* boxes, int ld,
                               int nc, int mode, int shift, int R,
                               int valid_n, int* skey, long long* n_act,
                               cudaStream_t st) {
  const long long per_block = static_cast<long long>(kThreads) * K;
  compact_key_kernel<K><<<static_cast<int>((R + per_block - 1) / per_block),
                          kThreads, 0, st>>>(
      in, boxes, ld, nc, mode, shift, R, valid_n, skey,
      reinterpret_cast<unsigned long long*>(n_act));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// k: rays a thread (1, 2 or 4; 1 or 2 only where it divides subg), or 0
// for the default (rays_per_thread).
int rt_pair_bits_k(const float* ox, const float* oy, const float* oz,
                   const float* ux, const float* uy, const float* uz,
                   const float* boxes, int ld, const int* member_tile, int nm,
                   const float* cap, const unsigned char* active, int R,
                   int subg, int nc, int* bits, int k, void* stream) {
  if (R <= 0 || subg <= 0 || R % subg || nc <= 0 || ld < 6 || nm < 0 ||
      (k && (k != 1 && k != 2 && k != 4)) || (k && subg % k))
    return static_cast<int>(cudaErrorInvalidValue);
  k = subgroup_k(R, subg, k);
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, active};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 4)
    err = launch_pair_bits<4>(in, boxes, ld, member_tile, nm, R, subg, nc,
                              bits, st);
  else if (k == 2)
    err = launch_pair_bits<2>(in, boxes, ld, member_tile, nm, R, subg, nc,
                              bits, st);
  else
    err = launch_pair_bits<1>(in, boxes, ld, member_tile, nm, R, subg, nc,
                              bits, st);
  return static_cast<int>(err);
}

int rt_pair_bits(const float* ox, const float* oy, const float* oz,
                 const float* ux, const float* uy, const float* uz,
                 const float* boxes, int ld, const int* member_tile, int nm,
                 const float* cap, const unsigned char* active, int R,
                 int subg, int nc, int* bits, void* stream) {
  return rt_pair_bits_k(ox, oy, oz, ux, uy, uz, boxes, ld, member_tile, nm,
                        cap, active, R, subg, nc, bits, 0, stream);
}

// rt_compact_bits: a compacted cast's live rows, shadow mask and culling
// words in one launch.  p: O(3), u(3), cap, active (the Rp rays' rows;
// cap and active null when absent), keys (the sorted keys, C of them
// read), member boxes (nm rows of ld floats), member_tile (nm), rows
// ((9 + extras) x C), active_out (C, null without active), bits (W x
// C / subg).  k: rays a thread, 1 or 2 dividing subg (0: rays_per_thread's
// choice, four taken as two).
int rt_compact_bits_k(void* const* p, int C, int mask, int nrows, int ld,
                      int nm, int subg, int nc, int k, void* stream) {
  const bool cap = p[6], active = p[7];
  if (C <= 0 || subg <= 0 || C % subg || nc <= 0 || ld < 6 || nm < 0 ||
      nrows != (active ? 11 : cap ? 10 : 9) || (k && k != 1 && k != 2) ||
      (k && subg % k))
    return static_cast<int>(cudaErrorInvalidValue);
  // at most two: four rays' gathered values pass a thread's 64 registers
  k = k ? k : subgroup_k(C, subg, 0) > 1 ? 2 : 1;
  auto f = [&](int j) { return static_cast<const float*>(p[j]); };
  const RayRows in{f(0), f(1), f(2), f(3), f(4), f(5), f(6),
                   static_cast<const unsigned char*>(p[7])};
  const Gather g{static_cast<const int*>(p[8]), static_cast<float*>(p[11]),
                 static_cast<unsigned char*>(p[12]), mask, C};
  const float* boxes = f(9);
  const int* tiles = static_cast<const int*>(p[10]);
  int* bits = static_cast<int*>(p[13]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      k == 2 ? launch_pair_bits<2, true>(in, boxes, ld, tiles, nm, C, subg,
                                         nc, bits, st, g)
             : launch_pair_bits<1, true>(in, boxes, ld, tiles, nm, C, subg,
                                         nc, bits, st, g);
  return static_cast<int>(err);
}

int rt_compact_bits(void* const* p, int C, int mask, int nrows, int ld,
                    int nm, int subg, int nc, void* stream) {
  return rt_compact_bits_k(p, C, mask, nrows, ld, nm, subg, nc, 0, stream);
}

// rt_tile_lists with k rays a thread (1, 2 or 4 dividing subg; 0: the
// default, tile_lists_k), in one launch where it fits (one 1) or in two
// always (one 0); bits the scratch of two launches (rt_tile_lists_scratch
// words), else unread.
int rt_tile_lists_ko(const float* ox, const float* oy, const float* oz,
                     const float* ux, const float* uy, const float* uz,
                     const float* boxes, int ld, const float* cap, int R,
                     int subg, int nc, int* bits, int* lists, int k, int one,
                     void* stream) {
  if (R <= 0 || subg <= 0 || R % subg || nc <= 0 || ld < 6 ||
      (k && (k != 1 && k != 2 && k != 4)) || (k && subg % k))
    return static_cast<int>(cudaErrorInvalidValue);
  k = tile_lists_k(R, subg, nc, k);
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 4)
    err = launch_tile_lists<4>(in, boxes, ld, R, subg, nc, bits, lists, one,
                               st);
  else if (k == 2)
    err = launch_tile_lists<2>(in, boxes, ld, R, subg, nc, bits, lists, one,
                               st);
  else
    err = launch_tile_lists<1>(in, boxes, ld, R, subg, nc, bits, lists, one,
                               st);
  return static_cast<int>(err);
}

// The int32 words of scratch rt_tile_lists_ko (k, one) needs for R rays,
// subgroup subg and nc tiles: 0 in one launch, else the (W, R / subg)
// words; -1 on arguments it refuses.
long long rt_tile_lists_scratch(int R, int subg, int nc, int k, int one) {
  if (R <= 0 || subg <= 0 || R % subg || nc <= 0 ||
      (k && (k != 1 && k != 2 && k != 4)) || (k && subg % k))
    return -1;
  if (one && tile_lists_one(subg, nc, tile_lists_k(R, subg, nc, k)))
    return 0;
  return static_cast<long long>((nc + 31) / 32) * (R / subg);
}

int rt_tile_lists_k(const float* ox, const float* oy, const float* oz,
                    const float* ux, const float* uy, const float* uz,
                    const float* boxes, int ld, const float* cap, int R,
                    int subg, int nc, int* bits, int* lists, int k,
                    void* stream) {
  return rt_tile_lists_ko(ox, oy, oz, ux, uy, uz, boxes, ld, cap, R, subg,
                          nc, bits, lists, k, 1, stream);
}

int rt_tile_lists(const float* ox, const float* oy, const float* oz,
                  const float* ux, const float* uy, const float* uz,
                  const float* boxes, int ld, const float* cap, int R,
                  int subg, int nc, int* bits, int* lists, void* stream) {
  return rt_tile_lists_ko(ox, oy, oz, ux, uy, uz, boxes, ld, cap, R, subg,
                          nc, bits, lists, 0, 1, stream);
}

int rt_compact_key_k(const float* ox, const float* oy, const float* oz,
                     const float* ux, const float* uy, const float* uz,
                     const float* boxes, int ld, int nc, int mode, int shift,
                     const float* cap, const unsigned char* active, int R,
                     int valid_n, int* skey, long long* n_act, int k,
                     void* stream) {
  if (R <= 0 || nc < 0 || ld < 6 || shift < 0 || shift > 31 ||
      (k && (k != 1 && k != 2 && k != 4)))
    return static_cast<int>(cudaErrorInvalidValue);
  // from K = 2: the cat's key then runs 2,048 blocks in two waves, one
  // block's ray loads under another's tests, and beats K = 4 in one wave
  // (bench/cull_design)
  k = rays_per_thread(2, k, [&](int kk) {
    return (static_cast<long long>(R) + kThreads * kk - 1) / (kThreads * kk);
  });
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, active};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k == 4)
    err = launch_compact_key<4>(in, boxes, ld, nc, mode, shift, R, valid_n,
                                skey, n_act, st);
  else if (k == 2)
    err = launch_compact_key<2>(in, boxes, ld, nc, mode, shift, R, valid_n,
                                skey, n_act, st);
  else
    err = launch_compact_key<1>(in, boxes, ld, nc, mode, shift, R, valid_n,
                                skey, n_act, st);
  return static_cast<int>(err);
}

int rt_compact_key(const float* ox, const float* oy, const float* oz,
                   const float* ux, const float* uy, const float* uz,
                   const float* boxes, int ld, int nc, int mode, int shift,
                   const float* cap, const unsigned char* active, int R,
                   int valid_n, int* skey, long long* n_act, void* stream) {
  return rt_compact_key_k(ox, oy, oz, ux, uy, uz, boxes, ld, nc, mode, shift,
                          cap, active, R, valid_n, skey, n_act, 0, stream);
}

}  // extern "C"
