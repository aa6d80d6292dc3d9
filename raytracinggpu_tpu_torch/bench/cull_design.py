"""The culling kernels of several trees on the same casts, on the card.

    python -m raytracinggpu_tpu_torch.bench.cull_design [DIR ...]
        [--no-ablation]

Builds the ``cull.cu`` of each ``csrc/`` directory given (this package's
when none is; another tree's from ``git archive``, say), and a design
copy of this tree's (ABLATION and PERSISTENT appended, under ``_build/``),
with the flags of ``ops/_kernels.py``, one nvcc process a source, all
started together (``bench/pairs_design.build_libraries``); another tree's
library is loaded twice, from two files: the spread two identical
libraries show in one process.  Each source must export ``rt_pair_bits``
and ``rt_compact_key`` with the C interface of ``ops/_kernels.load``; one
that also exports ``rt_pair_bits_k`` and ``rt_compact_key_k`` (rays a
thread forced: 1, 2 or 4) is timed at each of those too; one that exports
``rt_tile_lists`` and ``rt_tile_lists_k`` (the tiled culling) is timed on
the tiled casts of TILE_ROWS too, and this tree's ``rt_tile_lists_ko`` at
each of TILE_VARIANTS (rays a thread, one launch or two), beside the
design copy's persistent kernel at each of PERSISTENT_VARIANTS.

The calls: those the main-path frames make (``capture``: the headline
frame, ``array_bvh`` 512x512 spp 32 depth 5, with the ladder off for its
depth-1 full-width casts and on for a compacted one (rt_pair_bits on the
C rays its rows hold, ``row_args``) and the key; the 200,000-triangle
soup of ``bench/big_mesh.py``, 512x512 spp 4 depth 2, its depth-1 cast
and key), and the tiled culling's calls of the same two frames through
``traversal="pallas"`` (their depth-1 closest casts).  On each, every
library's kernel must equal the plain version bit for bit; it is timed
with CUDA events, replayed from a CUDA graph and eager (the tiled rows
also with the L2 emptied before each call, ``bench/_timing.timed(
flush_l2=True)``), the trees in turns (each row twice: in order, then
reversed), beside ``bench/cull.call_bound``'s bound and no-FMA floor.  On
the tiled casts it also times this tree's ``rt_pair_bits`` over the valid
tile boxes as members: the words alone.

Unless ``--no-ablation``: ABLATION's parts of the two-launch tiled
culling on the same casts (``ablate_kernel``: the ray loads alone, the
loads with the reciprocals, the staging alone, the staging and the slab
test loop on rays made in registers, with no load; and the rows pass
alone, ``tile_lists_kernel`` on the words), and the issue rate of FMNMX
(``min.NaN.f32`` and ``min.f32``) beside FMUL and FADD, in instructions an
SM and clock (``rt_ablate_issue``: eight independent chains a thread, 32
warps an SM).  Last, the SASS instructions a slab test of each kernel
(``cuobjdump -sass``: the innermost loop that holds the slab tests, over
its FMUL / 6, a slab test having six products).  Every line carries the
card's name and power limit.  Needs a CUDA device, nvcc and cuobjdump.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from raytracinggpu_tpu_torch.ops import _kernels

FORCED = (1, 2, 4)  # rays a thread of the *_k entry points
GRAPH_ITERS, EAGER_ITERS = 50, 20
# (row, frame, kernel, label of the call as TierLog names it)
ROWS = (("cat depth-1 closest, full width", "headline, the ladder off",
         "pair_bits", "depth 1 closest"),
        ("cat depth-1 shadow, full width", "headline, the ladder off",
         "pair_bits", "depth 1 shadow"),
        ("cat depth-1 closest, compacted", "headline", "pair_bits",
         "depth 1 closest"),
        ("cat depth-1 closest", "headline", "compact_key", "depth 1 closest"),
        ("soup depth-1 closest", "soup", "pair_bits", "depth 1 closest"),
        ("soup depth-1 closest", "soup", "compact_key", "depth 1 closest"))
# (row, frame) of the tiled culling's timed depth-1 closest casts
TILE_ROWS = (("cat pallas depth-1 closest", "headline, pallas"),
             ("soup pallas depth-1 closest", "soup, pallas"))
# rt_tile_lists_ko's (rays a thread, one) of this tree: one 1 in one launch
# where it fits (k 0: the default), 0 in two launches
TILE_VARIANTS = ((0, 1), (1, 1), (2, 1), (4, 1), (0, 0))
# rt_tile_lists_persistent's (rays a thread, blocks an SM; 0: the default,
# all the SM holds) of the design copy (PERSISTENT)
PERSISTENT_VARIANTS = ((0, 0), (4, 4), (2, 4))
# A one-launch design of rt_tile_lists that lost (PERF.md, §6), kept
# only here, appended to the design copy of this tree's cull.cu: blocks
# resident for the whole cast walk groups of subgroups, stage every valid
# tile box once into dynamic shared memory, and fetch the next group's ray
# rows by cp.async while this group tests.
PERSISTENT = r"""
namespace {

// The current device's SMs (132 if unread)
int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

// ------------------------------------- rt_tile_lists in one launch

constexpr int kRayRows = 7;  // O, u, cap: the rows a tiled cast's ray reads
// dynamic shared memory the one launch may take: two blocks an SM
constexpr int kFusedSmemMax = 112 * 1024;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// load_ray's ray from a block's ray buffer (row k at b[k * stride])
__device__ __forceinline__ SlabRay buffered_ray(const float* b, int stride,
                                                bool has_cap, bool live) {
  SlabRay q;
  const float nan = __int_as_float(0x7fffffff);
  if (!live) {
    q.o[0] = q.o[1] = q.o[2] = 0.0f;
    q.rc[0] = q.rc[1] = q.rc[2] = 1.0f;
    q.capm = nan;
    return q;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q.o[a] = b[a * stride];
    q.rc[a] = 1.0f / b[(3 + a) * stride];
  }
  const float cap = has_cap ? b[6 * stride] : __int_as_float(0x7f800000);
  q.capm = -kBig <= cap ? min_nan(kBig, cap) : nan;
  return q;
}

// Bytes of dynamic shared memory of tile_lists_fused_kernel<K>: every tile
// box, two ray buffers of kRayRows rows of kThreads * K rays, W words of
// each of G subgroups.
long long fused_smem(int nc, int W, int G, int K) {
  return static_cast<long long>(nc) * sizeof(Box) +
         2LL * kRayRows * kThreads * K * sizeof(float) +
         static_cast<long long>(W) * G * sizeof(unsigned);
}

// rt_tile_lists in one launch, where a block's words fit in one pass and
// the tile boxes in its shared memory.  Groups of G subgroups (kThreads *
// K rays at most, whole subgroups); block b takes groups b, b + gridDim.x,
// ...  It stages every valid tile once (stage_members with no member
// array, compacted), then for each group: the next group's ray rows go
// into the other ray buffer by cp.async (each thread copies its own K
// rays, so no barrier guards the buffers) while this group tests; the
// slab test loop, ballot and shared words are pair_bits_kernel's; then a
// warp a subgroup writes the group's rows from the words (emit_row), no
// scratch in device memory.
template <int K>
__global__ void __launch_bounds__(kThreads, kMinResident)
tile_lists_fused_kernel(RayRows in, const float* __restrict__ boxes, int ld,
                        int R, int subg, int nc, int W, int G,
                        int* __restrict__ lists) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPer = kThreads * K;
  Box* sbox = reinterpret_cast<Box*>(smem);
  float* rays = reinterpret_cast<float*>(sbox + nc);
  unsigned* words = reinterpret_cast<unsigned*>(rays + 2 * kRayRows * kPer);
  __shared__ int warp_n[kWarps];

  const int S = R / subg;
  const int n_groups = (S + G - 1) / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i0 = static_cast<int>(threadIdx.x) * K;
  const bool has_cap = in.cap != nullptr;
  const float* src[kRayRows] = {in.ox, in.oy, in.oz, in.ux,
                                in.uy, in.uz, in.cap};
  // this thread's K rays of group grp into buffer buf
  auto prefetch = [&](int grp, int buf) {
    const long long n_rays =
        static_cast<long long>(min(G, S - grp * G)) * subg;
    if (i0 >= n_rays) return;
    const long long r0 = static_cast<long long>(grp) * G * subg + i0;
    float* dst = rays + buf * kRayRows * kPer + i0;
#pragma unroll
    for (int k = 0; k < kRayRows; ++k)
      if (k < 6 || has_cap)
#pragma unroll
        for (int r = 0; r < K; ++r)
          cp_async4(dst + k * kPer + r, src[k] + r0 + r);
  };

  int grp = blockIdx.x;
  if (grp < n_groups) prefetch(grp, 0);
  cp_async_commit();
  int n_box = 0;  // every valid tile, word slot w * G
  for (int m0 = 0; m0 < nc; m0 += kBoxChunk)
    n_box += stage_members(sbox + n_box, warp_n, boxes, ld, nullptr, m0, nc,
                           nc, 0, nc, G);
  for (int buf = 0; grp < n_groups; grp += gridDim.x, buf ^= 1) {
    if (grp + static_cast<int>(gridDim.x) < n_groups)
      prefetch(grp + gridDim.x, buf ^ 1);
    cp_async_commit();
    cp_async_wait1();  // this thread's rays of grp have landed
    const int sg0 = grp * G;
    const int n_sg = min(G, S - sg0);
    const bool live = i0 < n_sg * subg;  // K | subg: all K rays or none
    SlabRay q[K];
#pragma unroll
    for (int r = 0; r < K; ++r)
      q[r] = buffered_ray(rays + buf * kRayRows * kPer + i0 + r, kPer,
                          has_cap, live);
    __syncthreads();  // the previous group's rows are written
    for (int i = threadIdx.x; i < W * G; i += kThreads) words[i] = 0u;
    __syncthreads();
    const int sg = live ? i0 / subg : -1;
    const int prev = __shfl_up_sync(kFull, sg, 1);
    const bool leader = live && (lane == 0 || prev != sg);
    const unsigned leaders = __ballot_sync(kFull, leader);
    const unsigned above = lane == 31 ? 0u : leaders & (kFull << (lane + 1));
    const int end = above ? __ffs(static_cast<int>(above)) - 1 : 32;
    const unsigned run =
        (end == 32 ? kFull : (1u << end) - 1u) & (kFull << lane);
    const unsigned lead_run = leader ? run : 0u;
    const unsigned sg_addr = static_cast<unsigned>(
        __cvta_generic_to_shared(&words[live ? sg : 0]));
#pragma unroll 2
    for (int j = 0; j < n_box; ++j) {
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
    __syncthreads();
    for (int s = warp; s < n_sg; s += kWarps)
      emit_row(words + s, G, sg0 + s, W, nc, lists);
  }
}

// Whether rt_tile_lists at K rays a thread runs in one launch
// (tile_lists_fused_kernel): whole subgroups in a group of kThreads * K
// rays, their words in one pass, the boxes in kFusedSmemMax.
bool tile_lists_fused(int subg, int nc, int K) {
  if (subg > kThreads * K) return false;
  const int W = (nc + 31) / 32, G = group_of(subg, K);
  return static_cast<long long>(W) * G <= kWordSlots &&
         fused_smem(nc, W, G, K) <= kFusedSmemMax;
}

template <int K>
int launch_persistent(const RayRows& in, const float* boxes, int ld, int R,
                      int subg, int nc, int* lists, int bps,
                      cudaStream_t st) {
  if (!tile_lists_fused(subg, nc, K)) return -1;
  const long long S = R / subg;
  const int W = (nc + 31) / 32, G = group_of(subg, K);
  const int smem = static_cast<int>(fused_smem(nc, W, G, K));
  auto kern = tile_lists_fused_kernel<K>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kern,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bps > 0 && bps < occ) occ = bps;
  const long long groups = (S + G - 1) / G;
  const long long resident =
      static_cast<long long>(occ > 0 ? occ : 1) * sm_count();
  kern<<<static_cast<int>(groups < resident ? groups : resident), kThreads,
         smem, st>>>(in, boxes, ld, R, subg, nc, W, G, lists);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The persistent design's list rows at k rays a thread (0: subgroup_k's)
// and at most bps blocks an SM (0: all it holds); -1 where its shared
// memory does not hold the table
extern "C" int rt_tile_lists_persistent(
    const float* ox, const float* oy, const float* oz, const float* ux,
    const float* uy, const float* uz, const float* boxes, int ld,
    const float* cap, int R, int subg, int nc, int* lists, int k, int bps,
    void* stream) {
  if (R <= 0 || subg <= 0 || R % subg || nc <= 0 || (k && subg % k))
    return -1;
  k = subgroup_k(R, subg, k);
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 4)
    return launch_persistent<4>(in, boxes, ld, R, subg, nc, lists, bps, st);
  if (k == 2)
    return launch_persistent<2>(in, boxes, ld, R, subg, nc, lists, bps, st);
  return launch_persistent<1>(in, boxes, ld, R, subg, nc, lists, bps, st);
}
"""
COLD_ITERS = 30
# The parts of the tiled culling (ABLATE_PARTS, in order) and the issue
# probe, appended to a copy of this tree's cull.cu: ablate_kernel<K, part>
# is pair_bits_kernel's launch shape (G subgroups a block, K rays a
# thread, one pass of words) doing one part only; whatever it computes is
# folded into a word written where it can never be equal to a sentinel,
# so that nothing is optimized away.
ABLATE_PARTS = ("ray loads alone", "ray loads and reciprocals",
                "staging alone", "staging and tests, no ray load")
PIPE_OPS = ("min.NaN.f32 (FMNMX)", "min.f32 (FMNMX)", "mul.rn.f32 (FMUL)",
             "add.rn.f32 (FADD)")
ABLATION = r"""
namespace {

template <int K, int kPart>
__global__ void __launch_bounds__(kThreads, kMinResident)
ablate_kernel(RayRows in, const float* __restrict__ boxes, int ld, int R,
              int subg, int nc, int G, unsigned* __restrict__ out) {
  __shared__ unsigned words[kWordSlots];
  __shared__ Box sbox[kBoxChunk];
  __shared__ int warp_n[kWarps];
  const int S = R / subg;
  const int sg0 = blockIdx.x * G;
  const int n_sg = min(G, S - sg0);
  const int i0 = static_cast<int>(threadIdx.x) * K;
  const bool live = i0 < n_sg * subg;
  const int lane = threadIdx.x & 31;
  unsigned acc = 0u;
  SlabRay q[K];
#pragma unroll
  for (int r = 0; r < K; ++r) {
    const int i = sg0 * subg + i0 + r;
    if (kPart == 0 && live) {
      acc ^= __float_as_uint(in.ox[i]) ^ __float_as_uint(in.oy[i]) ^
             __float_as_uint(in.oz[i]) ^ __float_as_uint(in.ux[i]) ^
             __float_as_uint(in.uy[i]) ^ __float_as_uint(in.uz[i]) ^
             (in.cap ? __float_as_uint(in.cap[i]) : 0u);
    } else if (kPart == 1) {
      q[r] = load_ray(in, i, live);
      acc ^= __float_as_uint(q[r].o[0] + q[r].rc[0] + q[r].o[1] +
                             q[r].rc[1] + q[r].o[2] + q[r].rc[2] + q[r].capm);
    } else if (kPart == 3) {  // a ray made in registers
      const float f = static_cast<float>(i & 1023) * (1.0f / 1024.0f);
      q[r].o[0] = f - 0.5f;
      q[r].o[1] = -10.0f + f;
      q[r].o[2] = 0.25f - f;
      q[r].rc[0] = 1.0f / (f - 0.4f);
      q[r].rc[1] = 1.0f / (0.3f + f);
      q[r].rc[2] = 1.0f / (0.7f - f);
      q[r].capm = live ? kBig : __int_as_float(0x7fffffff);
    }
  }
  if (kPart >= 2) {
    const int W = (nc + 31) / 32;
    for (int i = threadIdx.x; i < W * n_sg; i += kThreads) words[i] = 0u;
    const int sg = live ? i0 / subg : -1;
    const int prev = __shfl_up_sync(kFull, sg, 1);
    const bool leader = live && (lane == 0 || prev != sg);
    const unsigned leaders = __ballot_sync(kFull, leader);
    const unsigned above = lane == 31 ? 0u : leaders & (kFull << (lane + 1));
    const int end = above ? __ffs(static_cast<int>(above)) - 1 : 32;
    const unsigned run =
        (end == 32 ? kFull : (1u << end) - 1u) & (kFull << lane);
    const unsigned lead_run = leader ? run : 0u;
    const unsigned sg_addr = static_cast<unsigned>(
        __cvta_generic_to_shared(&words[live ? sg : 0]));
    for (int m0 = 0; m0 < nc; m0 += kBoxChunk) {
      const int n = stage_members(sbox, warp_n, boxes, ld, nullptr, m0, nc,
                                  nc, 0, 32 * W, n_sg);
      acc += n;
      if (kPart == 3) {
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
    }
    __syncthreads();
    acc += words[threadIdx.x % (W * n_sg)];
  }
  if (acc == 0x9e3779b9u) out[blockIdx.x] = acc;
}

template <int kOp>
__global__ void __launch_bounds__(kThreads) issue_kernel(float* out,
                                                          int iters,
                                                          float y) {
  float x[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) x[j] = static_cast<float>(threadIdx.x + j);
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (kOp == 0)
        asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(y));
      else if (kOp == 1)
        asm volatile("min.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(y));
      else if (kOp == 2)
        asm volatile("mul.rn.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(y));
      else
        asm volatile("add.rn.f32 %0, %0, %1;" : "+f"(x[j]) : "f"(y));
    }
  }
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += x[j];
  if (s == 1234.5f) out[blockIdx.x] = s;
}

template <int K, int kPart>
int ablate_k(const RayRows& in, const float* boxes, int ld, int R, int subg,
             int nc, unsigned* out, cudaStream_t st) {
  const int G = subg >= kThreads * K ? 1 : kThreads * K / subg;
  const int S = R / subg;
  ablate_kernel<K, kPart><<<(S + G - 1) / G, kThreads, 0, st>>>(
      in, boxes, ld, R, subg, nc, G, out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int ablate_part(int part, const RayRows& in, const float* boxes, int ld,
                int R, int subg, int nc, unsigned* out, cudaStream_t st) {
  switch (part) {
    case 0: return ablate_k<K, 0>(in, boxes, ld, R, subg, nc, out, st);
    case 1: return ablate_k<K, 1>(in, boxes, ld, R, subg, nc, out, st);
    case 2: return ablate_k<K, 2>(in, boxes, ld, R, subg, nc, out, st);
    default: return ablate_k<K, 3>(in, boxes, ld, R, subg, nc, out, st);
  }
}

}  // namespace

// ablate_kernel's part (0-3) at rt_tile_lists' rays a thread, one pass of
// words (the wrapper's K; -1 where a pass does not hold them)
extern "C" int rt_ablate_tiles(int part, const float* ox, const float* oy,
                               const float* oz, const float* ux,
                               const float* uy, const float* uz,
                               const float* boxes, int ld, const float* cap,
                               int R, int subg, int nc, unsigned* out,
                               void* stream) {
  const int k = subgroup_k(R, subg, 0);
  const int G = subg >= kThreads * k ? 1 : kThreads * k / subg;
  if (R % subg || ((nc + 31) / 32) * G > kWordSlots) return -1;
  const RayRows in{ox, oy, oz, ux, uy, uz, cap, nullptr};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 4) return ablate_part<4>(part, in, boxes, ld, R, subg, nc, out, st);
  if (k == 2) return ablate_part<2>(part, in, boxes, ld, R, subg, nc, out, st);
  return ablate_part<1>(part, in, boxes, ld, R, subg, nc, out, st);
}

// rt_tile_lists' second launch alone on words bits (W x S)
extern "C" int rt_ablate_rows(const unsigned* bits, int S, int nc,
                              int* lists, void* stream) {
  const long long threads = 32LL * S;
  tile_lists_kernel<<<static_cast<int>((threads + kThreads - 1) / kThreads),
                      kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      bits, S, (nc + 31) / 32, nc, lists);
  return static_cast<int>(cudaGetLastError());
}

// issue_kernel<op> on blocks x kThreads threads, iters x 8 operations each
extern "C" int rt_ablate_issue(int op, int blocks, int iters, float* out,
                               void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (op == 0)
    issue_kernel<0><<<blocks, kThreads, 0, st>>>(out, iters, 3.0f);
  else if (op == 1)
    issue_kernel<1><<<blocks, kThreads, 0, st>>>(out, iters, 3.0f);
  else if (op == 2)
    issue_kernel<2><<<blocks, kThreads, 0, st>>>(out, iters, 1.0f);
  else
    issue_kernel<3><<<blocks, kThreads, 0, st>>>(out, iters, 0.0f);
  return static_cast<int>(cudaGetLastError());
}
"""


def capture(render, n_bits: int, n_keys: int, n_lists: int = 0,
            n_compact: int = 0):
    """Run render() with ops/pairs_trace's ``_pair_bits``, ``_compact_key``
    and ``compact_bits`` and ops/pallas_trace's ``_block_active_tiles``
    wrapped so that the inputs of their first ``n_bits``, ``n_keys``,
    ``n_compact`` and ``n_lists`` calls are kept (cloned), each labelled
    with its depth and query as bench/ladder.TierLog tracks them; the
    wrapped functions are the real ones, which launch and count as always,
    and are put back afterwards.  Returns ({"pair_bits": [(label, args)],
    "compact_key": [...], "tile_lists": [...], "compact_bits": [...]},
    render's result).  A compacted cast culls in compact_bits, a
    full-width one in _pair_bits."""
    from raytracinggpu_tpu_torch.bench.ladder import TierLog
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    kept = {"pair_bits": [], "compact_key": [], "tile_lists": [],
            "compact_bits": []}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and not isinstance(x, Vec3):
            return tuple(map(clone, x))
        return Vec3(*(c.clone() for c in x)) if isinstance(x, Vec3) else x

    with TierLog():
        def keeping(name, n, fn):
            def call(*args):
                if len(kept[name]) < n:
                    depth, query = TierLog.where()
                    kept[name].append((f"depth {depth} {query}",
                                       tuple(map(clone, args))))
                return fn(*args)
            return call

        saved = (pt._pair_bits, pt._compact_key, pat._block_active_tiles,
                 pt.compact_bits)
        bits = keeping("pair_bits", n_bits, saved[0])
        pt._pair_bits = lambda O, u, nc, subg, members, cap=None, \
            active=None: bits(O, u, nc, subg, members, cap, active)
        pt._compact_key = keeping("compact_key", n_keys, saved[1])
        lists = keeping("tile_lists", n_lists, saved[2])
        pat._block_active_tiles = lambda O, u, aabb, n_tiles, cap=None, \
            subg=pat.SUBG: lists(O, u, aabb, n_tiles, cap, subg)
        pt.compact_bits = keeping("compact_bits", n_compact, saved[3])
        try:
            out = render()
        finally:
            (pt._pair_bits, pt._compact_key, pat._block_active_tiles,
             pt.compact_bits) = saved
    return kept, out


def _bind(path):
    """The library at ``path`` with the culling entry points' argtypes;
    (lib, whether it has the *_k entry points)."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"rt_pair_bits": [p] * 7 + [i, p, i, p, p, i, i, i, p],
            "rt_compact_key": [p] * 7 + [i] * 4 + [p, p, i, i, p, p]}
    has_k = all(hasattr(lib, f"{n}_k") for n in sigs)
    if hasattr(lib, "rt_tile_lists_k"):
        sigs["rt_tile_lists"] = [p] * 7 + [i, p, i, i, i, p, p]
    for name in list(sigs):
        if has_k or name == "rt_tile_lists":
            sigs[f"{name}_k"] = sigs[name] + [i]
    if hasattr(lib, "rt_tile_lists_ko"):
        sigs["rt_tile_lists_ko"] = sigs["rt_tile_lists"] + [i, i]
        lib.rt_tile_lists_scratch.argtypes = [i] * 5
        lib.rt_tile_lists_scratch.restype = ctypes.c_longlong
    if hasattr(lib, "rt_tile_lists_persistent"):
        sigs["rt_tile_lists_persistent"] = [p] * 7 + [i, p, i, i, i, p, i,
                                                      i]
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [p]
        fn.restype = i
    return lib, has_k


def launch(lib, name, args, k=None, ko=None, persistent=None):
    """One call of kernel ``name`` ("pair_bits", "compact_key" or
    "tile_lists") from ``lib`` on the arguments of
    ``ops/pairs_trace._pair_bits`` or ``_compact_key`` or
    ``ops/pallas_trace._block_active_tiles``, with ``k`` rays a thread
    forced when given, or for tile_lists ``ko`` = rt_tile_lists_ko's (rays
    a thread, one launch) or ``persistent`` = rt_tile_lists_persistent's
    (rays a thread, blocks an SM) (not counted in ``_kernels.LAUNCHES``);
    returns bits, (skey, n_act) or the list rows."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    ptr = lambda x: None if x is None else x.data_ptr()
    st = torch.cuda.current_stream().cuda_stream
    kk = () if k is None else (k,)
    if name == "pair_bits":
        O, u, nc, subg, (boxes, tiles), cap, active = args
        rows, cap, active, R = _kernels._ray_rows(O, u, cap, active)
        out = torch.empty((-(-nc // 32), R // subg), dtype=torch.int32,
                          device=boxes.device)
        fn = lib.rt_pair_bits_k if k else lib.rt_pair_bits
        err = fn(*(x.data_ptr() for x in rows), boxes.data_ptr(),
                 boxes.shape[1], tiles.data_ptr(), boxes.shape[0], ptr(cap),
                 ptr(active), R, subg, nc, out.data_ptr(), *kk, st)
    elif name == "tile_lists":
        O, u, aabb, nt, cap, subg = args
        rows, cap, _, R = _kernels._ray_rows(O, u, cap, None)
        out = torch.empty((R // subg, 1 + nt), dtype=torch.int32,
                          device=aabb.device)
        if persistent:
            err = lib.rt_tile_lists_persistent(
                *(x.data_ptr() for x in rows), aabb.data_ptr(),
                aabb.shape[1], ptr(cap), R, subg, nt, out.data_ptr(),
                *persistent, st)
            if err:
                raise SystemExit(f"cull_design: the persistent design "
                                 f"{persistent} failed ({err})")
            return out
        n = (-(-nt // 32) * (R // subg) if not hasattr(
            lib, "rt_tile_lists_ko") else lib.rt_tile_lists_scratch(
                R, subg, nt, *(ko or (k or 0, 1))))
        bits = torch.empty(n, dtype=torch.int32, device=aabb.device) \
            if n else None
        fn = (lib.rt_tile_lists_ko if ko else lib.rt_tile_lists_k if k
              else lib.rt_tile_lists)
        err = fn(*(x.data_ptr() for x in rows), aabb.data_ptr(),
                 aabb.shape[1], ptr(cap), R, subg, nt, ptr(bits),
                 out.data_ptr(), *(ko or kk), st)
    else:
        O, u, boxes, nc, cap, active, valid_n = args
        rows, cap, active, R = _kernels._ray_rows(O, u, cap, active)
        mode, shift = pt._key_mode(nc, R)
        skey = torch.empty(R, dtype=torch.int32, device=boxes.device)
        n_act = torch.empty((), dtype=torch.int64, device=boxes.device)
        out = (skey, n_act)
        fn = lib.rt_compact_key_k if k else lib.rt_compact_key
        err = fn(*(x.data_ptr() for x in rows), boxes.data_ptr(),
                 boxes.shape[1], nc, mode, shift, ptr(cap), ptr(active), R,
                 max(min(int(valid_n), R), 0), skey.data_ptr(),
                 n_act.data_ptr(), *kk, st)
    if err:  # the error's name from the package's library
        _kernels._raise_on(_kernels.load(), err, name)
    return out


def dispatching(name):
    """The function of the port that launches kernel ``name`` on CUDA
    tensors (its plain version on CPU tensors)."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    return {"pair_bits": pt._pair_bits, "compact_key": pt._compact_key,
            "tile_lists": pat._block_active_tiles}[name]


def plain(name, args):
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    if name == "pair_bits":
        return pt.pair_bits_plain(*args)
    if name == "tile_lists":
        return pat.block_active_tiles_plain(*args)
    return pt.compact_key_plain(*args)[:2]


def same(name, got, want) -> bool:
    if name != "compact_key":
        return torch.equal(got, want)
    return torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def forced(name, args):
    """The rays a thread (FORCED) that a call can be forced to: for
    pair_bits and tile_lists those dividing its subgroup."""
    subg = {"pair_bits": 3, "tile_lists": 5}.get(name)
    return [k for k in FORCED if subg is None or args[subg] % k == 0]


def hold_index_cases(cases) -> list:
    """Each case of ``bench/cull.index_cases`` through the dispatching
    function of ops/pairs_trace or ops/pallas_trace (the wrapper, rays a
    thread by default, counted in LAUNCHES) and through this package's *_k
    entry points at each of ``forced``: [(label, k or None, bitwise the
    plain version)]."""
    lib = _kernels.load()
    out = []
    for label, name, args, plain_args in cases:
        want = plain(name, plain_args)
        got = dispatching(name)(*args)
        torch.cuda.synchronize()
        out.append((label, None, same(name, got if name != "compact_key"
                                      else got[:2], want)))
        for k in forced(name, args):
            got = launch(lib, name, args, k)
            torch.cuda.synchronize()
            out.append((label, k, same(name, got, want)))
    return out


def graph_nodes(fn) -> list:
    """The node types (libcuda's CUgraphNodeType: 0 a kernel, 2 a
    memset, ...) of one CUDA graph capturing fn(): what one call puts on
    the stream, read from the graph, not from a profiler."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    return types


def frames_calls(device):
    """{frame: kept calls (``capture``)} of the headline frame with the
    ladder off and on, of the soup frame, and of both through the tiled
    traversal."""
    import dataclasses

    from raytracinggpu_tpu_torch.bench.ladder import build_scenes, ladder_off

    scenes = build_scenes(device, ["frames"])
    hcfg, _, head = scenes["headline"]
    scfg, _, soup = scenes["soup"]
    tiled = lambda c: dataclasses.replace(c, traversal="pallas")
    out = {}
    for where, render, n_bits, n_keys, n_lists, n_compact in (
            ("headline, the ladder off", lambda: head(ladder_off(hcfg), 0),
             4, 0, 0, 0),
            ("headline", lambda: head(hcfg, 0), 6, 4, 0, 4),
            ("soup", lambda: soup(scfg, 0), 4, 2, 0, 0),
            ("headline, pallas", lambda: head(tiled(hcfg), 0), 0, 0, 4, 0),
            ("soup, pallas", lambda: soup(tiled(scfg), 0), 0, 0, 4, 0)):
        out[where] = capture(render, n_bits, n_keys, n_lists, n_compact)[0]
        torch.cuda.synchronize()
    return out


def row_args(calls, where, name, lab):
    """The arguments of the kept call labelled ``lab``; for pair_bits on a
    compacted cast (whose rays cull in compact_bits) those of its
    compact_bits call's rays: O, u, cap and mask of the rows it gathers."""
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    kept = calls[where]
    hit = [a for la, a in kept[name] if la == lab]
    if hit or name != "pair_bits":
        return hit[0]
    keys, C, shift, O, u, nc, subg, members, cap, active = next(
        a for la, a in kept["compact_bits"] if la == lab)
    rows, act, _ = pt.compact_bits_plain(keys, C, shift, O, u, nc, subg,
                                         members, cap, active)
    return (Vec3(rows[6], rows[7], rows[8]), Vec3(rows[0], rows[1], rows[2]),
            nc, subg, members, None if cap is None else rows[9], act)


def _disasm(path):
    """{kernel name (pairs_design._kernel_name): [(address, text)]} of the
    SASS of the library at ``path``."""
    from raytracinggpu_tpu_torch.bench.pairs_design import _kernel_name

    tool = os.path.join(os.path.dirname(_kernels.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(_kernel_name(m.group(1)) or m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def slab_sass(instrs):
    """(instructions a slab test, FMNMX a slab test, tests an iteration)
    of the innermost loop (a backward branch with no other inside it) that
    holds the most FMUL, or None; a slab test has six FMUL."""
    addr = [a for a, _ in instrs]
    loops = []
    for i, (a, t) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a:
            lo = addr.index(int(m.group(1), 16)) if int(
                m.group(1), 16) in addr else None
            if lo is not None:
                loops.append((lo, i))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                        for l2, h2 in loops)]
    best = None
    for lo, hi in inner:
        body = [t for _, t in instrs[lo:hi + 1]]
        fmul = sum(1 for t in body if re.search(r"\bFMUL\b", t))
        if fmul and (best is None or fmul > best[1]):
            best = (body, fmul)
    if best is None:
        return None
    body, fmul = best
    tests = fmul / 6
    fmnmx = sum(1 for t in body if re.search(r"\bFMNMX\b", t))
    return len(body) / tests, fmnmx / tests, tests


def sass_report(libs, label) -> None:
    for v, (path, _) in libs.items():
        try:
            funcs = _disasm(path)
        except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
            print(f"sass {label(v)}: not read ({e})")
            continue
        for name in sorted(funcs):
            if not any(k in name for k in ("pair_bits", "compact_key")):
                continue
            got = slab_sass(funcs[name])
            nan = sum(1 for _, t in funcs[name] if "FMNMX" in t and "NAN" in t)
            print(f"sass {label(v)} {name}: "
                  + ("innermost slab loop not found" if got is None else
                     f"{got[0]:.2f} instructions a slab test ({got[1]:.2f} "
                     f"FMNMX; {got[2]:g} tests an iteration)")
                  + f"; {nan} FMNMX with NaN propagation in the kernel",
                  flush=True)


def run(sources, card: str, device="cuda", ablation: bool = True) -> dict:
    """Times every source's kernels on the kept calls (another tree's
    library twice, from two files); returns {(row, kernel): {(tree label,
    k): [graph ms, ...]}}."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.compact_bits_design import _copy
    from raytracinggpu_tpu_torch.bench.cull import call_bound
    from raytracinggpu_tpu_torch.bench.pairs_design import (
        build_libraries, kernel_resources)

    this_tree = lambda v: os.path.isdir(v) and os.path.samefile(
        v, _kernels.CSRC)
    label = lambda v: "this tree" if this_tree(v) else v
    extra = (write_design_copy(), "cull.cu")
    built = build_libraries([(v, "cull.cu") for v in sources] + [extra])
    design = _bind(built[extra][0])[0]
    libs = {v: built[v, "cull.cu"] for v in sources}
    bound_libs = {v: _bind(path) for v, (path, _) in libs.items()}
    for v, (path, _) in libs.items():
        if not this_tree(v):
            bound_libs[f"{v} (a second copy)"] = _bind(_copy(path))
    for v, (_, report) in libs.items():
        res = kernel_resources(report)
        print(f"{label(v)}: " + ", ".join(
            f"{k}: {r} registers, {s} B smem" for k, (r, s) in sorted(
                res.items())))
    calls = frames_calls(device)
    results = {}
    for row, where, name, lab in ROWS:
        args = row_args(calls, where, name, lab)
        want = plain(name, args)
        torch.cuda.synchronize()
        bound, by, floor = call_bound(name, args, want)
        variants = []
        for v, (lib, has_k) in bound_libs.items():
            for k in ((None, *forced(name, args)) if has_k else (None,)):
                got = launch(lib, name, args, k)
                torch.cuda.synchronize()
                if not same(name, got, want):
                    raise SystemExit(f"cull_design: {label(v)}'s {name} "
                                     f"(k {k}) differs from the plain "
                                     f"version on the {row} cast")
                variants.append((v, lib, k))
        res = results[row, name] = {}
        for order in (variants, variants[::-1]):
            for v, lib, k in order:
                fn = lambda: launch(lib, name, args, k)
                g = timed(fn, GRAPH_ITERS, graph=True) * 1e3
                e = timed(fn, EAGER_ITERS) * 1e3
                res.setdefault((label(v), k), []).append((g, e))
        n_boxes = args[4][0].shape[0] if name == "pair_bits" else args[3]
        for (v, k), ms in res.items():
            g = [x for x, _ in ms]
            print(f"{name} on the {row} cast ({args[0].x.shape[0]} rays, "
                  f"{n_boxes} boxes), {v}, k {k or 'auto'}: graph "
                  f"{', '.join(f'{x:.4f}' for x in g)} ms, eager "
                  f"{', '.join(f'{y:.4f}' for _, y in ms)} ms; bound "
                  f"{bound:.4f} ({by}, {bound / min(g):.1%}), no-FMA floor "
                  f"{floor:.4f} ({floor / min(g):.1%}); bitwise the plain "
                  f"version; on {card}", flush=True)
    tile_calls = []
    for row, where in TILE_ROWS:
        args = next(a for la, a in calls[where]["tile_lists"]
                    if la == "depth 1 closest")
        time_tile_row(row, args, bound_libs, design, label, results, card)
        tile_calls.append((row, args))
    if ablation:
        ablate(built[extra][0], tile_calls, card)
    sass_report(libs, label)
    return results


def time_tile_row(row, args, bound_libs, design, label, results,
                  card) -> None:
    """The tiled culling on one kept cast: each library that has
    ``rt_tile_lists`` (and each rays-a-thread; this tree's at each of
    TILE_VARIANTS, and the design copy's persistent kernel at each of
    PERSISTENT_VARIANTS), bitwise the plain version, timed in turns as
    ``run``'s rows are and with the L2 emptied, and this tree's
    ``rt_pair_bits`` over the valid tile boxes as members (the words
    alone)."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.cull import call_bound

    name = "tile_lists"
    O, u, aabb, nt, cap, subg = args
    want = plain(name, args)
    torch.cuda.synchronize()
    bound, by, floor = call_bound(name, args, want)
    valid = aabb[:nt, 0] <= aabb[:nt, 3]
    tiles = torch.where(valid, torch.arange(nt, device=aabb.device),
                        -1).to(torch.int32)
    words = (O, u, nt, subg, (aabb[:nt].contiguous(), tiles), cap, None)
    this = _kernels.load()
    variants = [("words alone (rt_pair_bits)", this, "pair_bits", {})]
    for v, (lib, _) in bound_libs.items():
        if not hasattr(lib, "rt_tile_lists_k"):
            continue
        kws = ([{"ko": ko} for ko in TILE_VARIANTS
                if not ko[0] or subg % ko[0] == 0]
               if hasattr(lib, "rt_tile_lists_ko") else
               [{"k": k} for k in (None, *forced(name, args))])
        variants += [(label(v), lib, name, kw) for kw in kws]
    variants += [("persistent design (this tree's design copy)", design,
                  name, {"persistent": kb}) for kb in PERSISTENT_VARIANTS
                 if not kb[0] or subg % kb[0] == 0]
    for v, lib, kern, kw in variants[1:]:
        got = launch(lib, kern, args, **kw)
        torch.cuda.synchronize()
        if not same(name, got, want):
            raise SystemExit(f"cull_design: {v}'s tile_lists ({kw}) "
                             f"differs from the plain version on the {row} "
                             "cast")
    res = results[row, name] = {}
    for order in (variants, variants[::-1]):
        for v, lib, kern, kw in order:
            a = words if kern == "pair_bits" else args
            fn = lambda: launch(lib, kern, a, **kw)
            g = timed(fn, GRAPH_ITERS, graph=True) * 1e3
            c = timed(fn, COLD_ITERS, graph=True, flush_l2=True) * 1e3
            e = timed(fn, EAGER_ITERS) * 1e3
            res.setdefault((v, str(kw)), []).append((g, c, e))
    for (v, kw), ms in res.items():
        g, c, e = ([m[j] for m in ms] for j in range(3))
        f = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
        print(f"tile_lists on the {row} cast ({O.x.shape[0]} rays, "
              f"{int(valid.sum())} valid of {nt} tiles, subgroup {subg}), "
              f"{v} {kw}: graph {f(g)} ms, L2 emptied {f(c)} ms, eager "
              f"{f(e)} ms; bound {bound:.4f} ({by}, {bound / min(g):.1%}), "
              f"no-FMA floor {floor:.4f} ({floor / min(g):.1%}); bitwise "
              f"the plain version; on {card}", flush=True)


def write_design_copy() -> str:
    """This tree's cull.cu with ABLATION and PERSISTENT appended, written
    under _build/; returns its directory."""
    with open(os.path.join(_kernels.CSRC, "cull.cu")) as f:
        text = f.read()
    d = os.path.join(_kernels.BUILD_DIR, "cull_design_copy")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "cull.cu"), "w") as f:
        f.write(text + ABLATION + PERSISTENT)
    return d


def ablate(path, calls, card) -> None:
    """ABLATE_PARTS and the rows pass alone on each tiled call (row,
    args), then the issue rates of PIPE_OPS, from the library at
    ``path`` (``write_design_copy``'s)."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.sphere_scatter_design import (
        sm_clock_hz)

    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rt_ablate_tiles.argtypes = [i] + [p] * 7 + [i, p, i, i, i, p, p]
    lib.rt_ablate_rows.argtypes = [p, i, i, p, p]
    lib.rt_ablate_issue.argtypes = [i, i, i, p, p]
    for fn in (lib.rt_ablate_tiles, lib.rt_ablate_rows, lib.rt_ablate_issue):
        fn.restype = i
    this = _kernels.load()
    for row, args in calls:
        O, u, aabb, nt, cap, subg = args
        rows, cap, _, R = _kernels._ray_rows(O, u, cap, None)
        out = torch.zeros(R, dtype=torch.int32, device=aabb.device)
        ptr = lambda x: None if x is None else x.data_ptr()
        st = lambda: torch.cuda.current_stream().cuda_stream
        times = {}
        for part, what in enumerate(ABLATE_PARTS):
            fn = lambda part=part: lib.rt_ablate_tiles(
                part, *(x.data_ptr() for x in rows), aabb.data_ptr(),
                aabb.shape[1], ptr(cap), R, subg, nt, out.data_ptr(), st())
            if fn():
                print(f"ablation {row}: {what}: not run (the words pass more "
                      "than once)")
                break
            times[what] = [timed(fn, GRAPH_ITERS, graph=True) * 1e3
                           for _ in range(2)]
        S, W = R // subg, -(-nt // 32)
        valid = aabb[:nt, 0] <= aabb[:nt, 3]
        tiles = torch.where(valid, torch.arange(nt, device=aabb.device),
                            -1).to(torch.int32)
        bits = _kernels.pair_bits(O, u, nt, subg, (aabb[:nt].contiguous(),
                                                   tiles), cap)
        lists = torch.empty((S, 1 + nt), dtype=torch.int32,
                            device=aabb.device)
        rows_fn = lambda: lib.rt_ablate_rows(bits.data_ptr(), S, nt,
                                             lists.data_ptr(), st())
        times["rows pass alone (tile_lists_kernel)"] = [
            timed(rows_fn, GRAPH_ITERS, graph=True) * 1e3 for _ in range(2)]
        if not torch.equal(lists, plain("tile_lists", args)):
            raise SystemExit(f"cull_design: the rows pass differs on {row}")
        empty = lambda: lib.rt_ablate_issue(0, 1, 0, out.data_ptr(), st())
        times["an empty launch"] = [timed(empty, GRAPH_ITERS, graph=True)
                                    * 1e3 for _ in range(2)]
        for what, ms in times.items():
            print(f"ablation {row} ({R} rays, {int(valid.sum())} valid of "
                  f"{nt} tiles, subgroup {subg}, {W} words a subgroup): "
                  f"{what}: graph {', '.join(f'{t:.4f}' for t in ms)} ms on "
                  f"{card}", flush=True)
    hz, src = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 8 * sms, 4096
    scratch = torch.zeros(blocks, dtype=torch.float32, device="cuda")
    for op, what in enumerate(PIPE_OPS):
        fn = lambda op=op: lib.rt_ablate_issue(
            op, blocks, iters, scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        t = min(timed(fn, 5) for _ in range(3))
        rate = blocks * 128 * iters * 8 / t / sms / hz
        print(f"issue rate {what}: {rate:.1f} a clock and SM ({blocks} "
              f"blocks of 128 threads, {iters} x 8 independent operations a "
              f"thread, {t * 1e3:.4f} ms at {hz / 1e6:.0f} MHz, {src}; one a "
              f"lane and clock is 128) on {card}", flush=True)
    del this


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", default=[_kernels.CSRC],
                    help="csrc/ directories whose cull.cu to time")
    ap.add_argument("--no-ablation", action="store_true",
                    help="leave out the ablation and the issue rates")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cull_design: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    run(a.csrc, card, ablation=not a.no_ablation)
    return 0


if __name__ == "__main__":
    sys.exit(main())
