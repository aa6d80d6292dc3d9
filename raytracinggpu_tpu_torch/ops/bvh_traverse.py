"""Stackless flat-BVH traversal, ``traversal="bvh"`` (port of
``raytracinggpu_tpu/ops/bvh_traverse.py``).

The reference's flat-array walk with a per-thread stack, in the preorder
skip-link form of the same tree (``accel/bvh.py``): every ray walks the
nodes in preorder; on a box miss it jumps to ``skip[node]``, the first
node after the subtree, on a hit it goes to ``node + 1`` (the first child,
or the leaf's triangles).  All rays advance together, one node a step, as
torch ops on tensors; a finished ray idles at ``node == n_nodes``.  The
JAX walk is an XLA ``while_loop`` and reaches no Pallas kernel, so this
module has no CUDA kernel: it is the oracle mode of the reference's
acceleration structure, and its loop ends on the host's test of the
live rays.

A ray at a leaf tests the leaf's first ``max_leaf_tris`` triangles
(``RenderConfig.bvh_max_leaf``; past it the JAX walk tests none, and
neither does this one) with the factorized Moller-Trumbore feature matrix
of ``ops/triangle.py``.  The JAX walk unrolls that test into
``max_leaf_tris`` sequential updates with a strict ``<`` over every ray;
here the (ray, triangle) pairs of every ray at a leaf are tested at once,
flattened: the first triangle that attains the least valid t wins, and
replaces the ray's best only where that t is strictly smaller, which is
the sequential result exactly.  Each of the four
10-term sums adds its products left to right, every product and sum
rounded, so that a kernel could be bitwise to it; the JAX walk sums in an
``einsum`` whose order is XLA's, so the two agree under the dense
oracle's standard, not bit for bit.

Node layouts: ``soa`` gathers each node field from its own column;
``aos10`` builds the reference's 10-float record [left, right, mn.xyz,
mx.xyz, start, end] and gathers one row a step.  Both give bit-identical
hits; ``aos10`` holds indices as f32, exact only below 2^24, and refuses
larger tables.
"""
from __future__ import annotations

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.triangle import (
    INF32,
    NUM_RAY_FEATURES,
    TriHit,
    TriTables,
    ray_features,
)

# Triangles a leaf test covers by default: the midpoint split stops when
# fewer than 5 triangles remain OR the partition degenerates, and the
# cat's worst leaf holds 73.
MAX_LEAF_TRIS = 96
# Steps between two host reads of the live-ray count.
_SYNC_EVERY = 4


def _node_fetch(bvh, node_layout: str, n_tri: int):
    """fetch(nd) -> (mn, mx, is_leaf, start, end) per ray for the layout."""
    if node_layout == "aos10":
        n_nodes = bvh.left.shape[0]
        if max(n_nodes, n_tri) >= 1 << 24:
            raise ValueError(
                "node_layout='aos10' stores node/triangle indices as "
                "float32 (exact below 2^24); use node_layout='soa' for "
                "meshes this large")
        nodes10 = torch.stack(
            [bvh.left.float(), bvh.right.float(), *bvh.mn, *bvh.mx,
             bvh.tri_start.float(), bvh.tri_end.float()], dim=1)

        def fetch(nd):
            rows = nodes10[nd]                          # one (R, 10) gather
            return (Vec3(rows[:, 2], rows[:, 3], rows[:, 4]),
                    Vec3(rows[:, 5], rows[:, 6], rows[:, 7]),
                    rows[:, 1] == -1.0, rows[:, 8].int(), rows[:, 9].int())
        return fetch
    if node_layout != "soa":
        raise ValueError(f"unknown node_layout {node_layout!r}")

    def fetch(nd):
        return (Vec3(*(c[nd] for c in bvh.mn)), Vec3(*(c[nd] for c in bvh.mx)),
                bvh.right[nd] == -1, bvh.tri_start[nd], bvh.tri_end[nd])
    return fetch


def _slab_hit(O: Vec3, rcp: Vec3, mn: Vec3, mx: Vec3):
    """The reference's slab test: min of the far planes > max of the near
    planes, with no behind-the-ray test."""
    t0 = [(a - o) * r for a, o, r in zip(mn, O, rcp)]
    t1 = [(a - o) * r for a, o, r in zip(mx, O, rcp)]
    lo = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    hi = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    enter = torch.maximum(lo[0], torch.maximum(lo[1], lo[2]))
    exit_ = torch.minimum(hi[0], torch.minimum(hi[1], hi[2]))
    return exit_ > enter


def leaf_test(f, mtT, start, count, eps: float):
    """Closest valid hit of each ray over its triangles start..start+count-1.

    f: (n, 10) ray features; mtT: (Tp, 40) the feature matrix with one row
    a triangle (feature-major, then output); start, count: (n,) int64.
    The (ray, triangle) pairs are tested flattened, so a long leaf costs
    only its own rays.  Returns (t, idx, beta, gamma),
    t = INF where no triangle is valid; the lowest index wins exact-t
    ties."""
    n, dev = start.shape[0], f.device
    total = int(count.sum())
    if total == 0:
        z = torch.zeros((n,), device=dev)
        return z + INF32, z.int(), z, z
    first = torch.cumsum(count, 0) - count
    lane = torch.repeat_interleave(torch.arange(n, device=dev), count,
                                   output_size=total)
    pair = torch.arange(total, device=dev)
    ti = start[lane] + (pair - first[lane])
    cols = mtT[ti].view(total, NUM_RAY_FEATURES, 4)
    prod = f[lane][:, :, None] * cols                    # (pairs, 10, 4)
    s = prod[:, 0]
    for j in range(1, NUM_RAY_FEATURES):                 # left to right
        s = s + prod[:, j]
    denom, bn, gn, tn = s.unbind(-1)
    beta = bn / denom
    gamma = gn / denom
    t = tn / denom
    valid = ((denom != 0.0)
             & (beta >= 0.0) & (beta <= 1.0)
             & (gamma >= 0.0) & (gamma <= 1.0)
             & (beta + gamma <= 1.0)
             & (t > 0.0) & (t > eps))
    t = torch.where(valid, t, INF32)
    t_min = torch.full((n,), INF32, device=dev).scatter_reduce(
        0, lane, t, "amin")
    win = torch.full((n,), total, device=dev).scatter_reduce(
        0, lane, torch.where(t == t_min[lane], pair, total), "amin")
    win = win.clamp_max(total - 1)
    return t_min, ti[win].int(), beta[win], gamma[win]


def intersect_tris_bvh(O: Vec3, u: Vec3, tab: TriTables, bvh,
                       eps_leaf: float, max_leaf_tris: int = MAX_LEAF_TRIS,
                       node_layout: str = "soa") -> TriHit:
    """Closest hit by the skip-link walk.  Each step every live ray
    fetches its node, slab-tests it, and descends (``node + 1``) or skips
    the subtree; a ray at a leaf whose box it hits tests up to
    ``max_leaf_tris`` of the leaf's triangles.  Returns TriHit(t, idx,
    beta, gamma): t = INF and idx 0 on a miss."""
    R = O.x.shape[0]
    dev = O.x.device
    n_nodes = bvh.left.shape[0]
    Tp = tab.mt.shape[-1]
    fetch = _node_fetch(bvh, node_layout, Tp)
    eps = float(np.float32(eps_leaf))
    mtT = tab.mt.reshape(NUM_RAY_FEATURES * 4, Tp).T.contiguous()

    t_best = torch.full((R,), INF32, device=dev)
    i_best = torch.zeros((R,), dtype=torch.int32, device=dev)
    b_best = torch.zeros((R,), device=dev)
    g_best = torch.zeros((R,), device=dev)
    # The walk runs on the rays still walking (``lanes``), dropped every
    # few steps once they finish: each ray's result is its own, and the
    # long walks of a few rays then cost only those rays.
    lanes = torch.arange(R, device=dev)
    node = torch.zeros((R,), dtype=torch.int32, device=dev)
    Ow, rcp, f = O, Vec3(*(1.0 / c for c in u)), ray_features(O, u)
    step = 0
    while lanes.numel():
        live = node < n_nodes
        nd = node.clamp_max(n_nodes - 1).long()
        mn, mx, is_leaf, start, end = fetch(nd)
        hit = _slab_hit(Ow, rcp, mn, mx) & live
        rows = (hit & is_leaf).nonzero()[:, 0]
        if rows.numel():
            s = start[rows].long()
            count = (end[rows].long() - s).clamp(0, max(max_leaf_tris, 0))
            t, i, b, g = leaf_test(f[rows], mtT, s, count, eps)
            lane = lanes[rows]
            better = t < t_best[lane]
            lane = lane[better]
            t_best[lane] = t[better]
            i_best[lane] = i[better]
            b_best[lane] = b[better]
            g_best[lane] = g[better]
        nxt = torch.where(hit & ~is_leaf, node + 1, bvh.skip[nd])
        node = torch.where(live, nxt, node)
        step += 1
        if step % _SYNC_EVERY == 0:
            keep = (node < n_nodes).nonzero()[:, 0]
            if keep.numel() < lanes.numel():
                lanes, node, f = lanes[keep], node[keep], f[keep]
                Ow = Vec3(*(c[keep] for c in Ow))
                rcp = Vec3(*(c[keep] for c in rcp))
    return TriHit(t=t_best, idx=i_best, beta=b_best, gamma=g_best)
