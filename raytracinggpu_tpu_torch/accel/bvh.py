"""Host BVH builder emitting flat SoA node arrays (port of
``raytracinggpu_tpu/accel/bvh.py``: the numpy builder, or the native one
of ``native.py``).

The reference's recursive median-of-space build, with identical semantics:

- node bbox over all three vertices of every triangle in [start, end),
- split axis = longest bbox extent with the reference's >=-priority tie-break,
- split plane at the bbox midpoint of that axis,
- in-place swap partition of the triangle index array by centroid
  ((A+B+C)/3), which keeps every node's triangle range contiguous,
- leaf when the partition degenerates (pivot <= start or pivot >= end-1) or
  fewer than 5 triangles remain.

Nodes are emitted in preorder with ``right == -1`` marking a leaf, plus
preorder skip links.  ``to_reference_layout`` gives the reference's
10-float node record, ``check_invariants`` the tree's structural checks,
and ``cluster_cut`` partitions the same tree into contiguous bounded-size
clusters for the pairs tables.
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

from raytracinggpu_tpu_torch import native as native_mod

LEAF_MIN_TRIS = 5  # reference: triangle_end - triangle_start < 5
NODE_FLOATS = 10   # reference flat record width


@dataclass
class FlatBVH:
    """Flat preorder BVH (host numpy).

    left/right: child node indices, -1 for leaves (right == -1 marks a leaf).
    mn/mx: (N, 3) AABB corners.
    tri_start/tri_end: triangle range in the *reordered* triangle array.
    order: (T,) permutation mapping new triangle position -> original index.
    skip: (N,) preorder escape link (N == len when the subtree is last).
    """

    left: np.ndarray
    right: np.ndarray
    mn: np.ndarray
    mx: np.ndarray
    tri_start: np.ndarray
    tri_end: np.ndarray
    order: np.ndarray
    skip: np.ndarray

    @property
    def n_nodes(self) -> int:
        return len(self.left)

    def to_reference_layout(self) -> np.ndarray:
        """The reference's 10-float node record, flattened:
        [left, right, mn.xyz, mx.xyz, start, end] per node."""
        out = np.zeros((self.n_nodes, NODE_FLOATS), np.float32)
        out[:, 0] = self.left
        out[:, 1] = self.right
        out[:, 2:5] = self.mn
        out[:, 5:8] = self.mx
        out[:, 8] = self.tri_start
        out[:, 9] = self.tri_end
        return out.reshape(-1)


def build_bvh(A: np.ndarray, B: np.ndarray, C: np.ndarray,
              native: bool | None = None) -> FlatBVH:
    """Build from triangle vertex arrays (T, 3); returns the flat preorder BVH.

    The recursion and the swap-based partition replicate the reference
    exactly (including its non-stable partition order), so the triangle
    ordering and tree shape equal the JAX package's builder bit for bit.

    native: the C++ builder (``native.resolve``: False numpy, True the
    library or RuntimeError, None the library when it builds), the same
    tree bit for bit.
    """
    lib = native_mod.resolve(native)
    if lib is not None:
        left, right, start, end, skip, mn, mx, order = native_mod.build_bvh(
            lib, A, B, C)
        return FlatBVH(left=left, right=right, mn=mn, mx=mx, tri_start=start,
                       tri_end=end, order=order, skip=skip)
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    order = np.arange(T)
    cen = (A + B + C) / 3.0  # float32 centroid

    left, right, mns, mxs, starts, ends = [], [], [], [], [], []

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def emit() -> int:
        idx = len(left)
        for lst in (left, right, starts, ends):
            lst.append(-1)
        mns.append(None)
        mxs.append(None)
        return idx

    def build(node: int, s: int, e: int) -> None:
        ids = order[s:e]
        pts = np.concatenate([A[ids], B[ids], C[ids]], axis=0)
        mn = pts.min(axis=0)
        mx = pts.max(axis=0)
        starts[node], ends[node] = s, e
        mns[node], mxs[node] = mn, mx

        d = mx - mn
        # reference tie-break: x wins >=, then y
        if d[0] >= d[1] and d[0] >= d[2]:
            axis = 0
        elif d[1] >= d[0] and d[1] >= d[2]:
            axis = 1
        else:
            axis = 2
        split = (mn[axis] + mx[axis]) / 2.0

        # In-place swap partition over the order array.  Positions j > i
        # are never written before the loop visits them, so the original
        # per-position `less` flags are exactly what the reference
        # compares; the swap sequence is replicated verbatim.
        seg = order[s:e]
        less = cen[seg, axis] < split
        n_less = int(less.sum())
        if 0 < n_less < len(seg):
            tmp = seg.copy()
            p = 0
            for i in range(len(tmp)):
                if less[i]:
                    tmp[i], tmp[p] = tmp[p], tmp[i]
                    p += 1
            order[s:e] = tmp
        pivot = s + n_less

        if pivot <= s or pivot >= e - 1 or e - s < LEAF_MIN_TRIS:
            return
        li = emit()
        left[node] = li
        build(li, s, pivot)
        ri = emit()
        right[node] = ri
        build(ri, pivot, e)

    root = emit()
    build(root, 0, T)

    n = len(left)
    flat = FlatBVH(
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        mn=np.stack(mns).astype(np.float32),
        mx=np.stack(mxs).astype(np.float32),
        tri_start=np.asarray(starts, np.int32),
        tri_end=np.asarray(ends, np.int32),
        order=order,
        skip=np.zeros(n, np.int32),
    )
    _compute_skip_links(flat)
    return flat


def _compute_skip_links(bvh: FlatBVH) -> None:
    """skip[i] = preorder index of the first node after i's subtree."""
    n = bvh.n_nodes
    stack = [(0, n)]
    while stack:
        node, escape = stack.pop()
        bvh.skip[node] = escape
        l, r = bvh.left[node], bvh.right[node]
        if r != -1:
            stack.append((r, escape))  # right child escapes like the parent
            stack.append((l, r))       # left child escapes to right sibling


def check_invariants(bvh: FlatBVH, A, B, C) -> None:
    """Structural invariants of a flat tree; raises AssertionError on a
    violation: ``order`` a permutation, preorder children that partition
    their parent's range inside its box, boxes that contain their
    triangles, leaf ranges that partition [0, T), skip links past the
    node."""
    n = bvh.n_nodes
    T = len(bvh.order)
    assert sorted(bvh.order.tolist()) == list(range(T)), "order not a permutation"
    is_leaf = bvh.right == -1
    assert is_leaf[0] or (bvh.left[0] == 1), "preorder: left child follows parent"
    for i in range(n):
        s, e = bvh.tri_start[i], bvh.tri_end[i]
        assert s < e
        if not is_leaf[i]:
            l, r = bvh.left[i], bvh.right[i]
            assert bvh.tri_start[l] == s and bvh.tri_end[r] == e
            assert bvh.tri_end[l] == bvh.tri_start[r]
            assert (bvh.mn[l] >= bvh.mn[i] - 1e-5).all() and (bvh.mx[l] <= bvh.mx[i] + 1e-5).all()
            assert (bvh.mn[r] >= bvh.mn[i] - 1e-5).all() and (bvh.mx[r] <= bvh.mx[i] + 1e-5).all()
        ids = bvh.order[s:e]
        pts = np.concatenate([A[ids], B[ids], C[ids]])
        assert (pts.min(0) >= bvh.mn[i] - 1e-4).all() and (pts.max(0) <= bvh.mx[i] + 1e-4).all()
    leaf_ranges = sorted(
        (bvh.tri_start[i], bvh.tri_end[i]) for i in range(n) if is_leaf[i]
    )
    pos = 0
    for s, e in leaf_ranges:
        assert s == pos, f"leaf gap at {pos}"
        pos = e
    assert pos == T
    assert ((bvh.skip > np.arange(n)) & (bvh.skip <= n)).all()


class ClusterCut(NamedTuple):
    """Level-cut of the BVH into K contiguous triangle clusters.

    starts/ends: (K,) triangle ranges (contiguous, partitioning [0, T)).
    mn/mx: (K, 3) cluster AABBs.
    """

    starts: np.ndarray
    ends: np.ndarray
    mn: np.ndarray
    mx: np.ndarray


def cluster_cut(bvh: FlatBVH, max_tris: int = 64) -> ClusterCut:
    """Cut the tree at the shallowest nodes holding <= max_tris triangles
    (iterative preorder)."""
    starts, ends, mns, mxs = [], [], [], []
    stack = [0]
    while stack:
        node = stack.pop()
        s, e = bvh.tri_start[node], bvh.tri_end[node]
        if e - s <= max_tris or bvh.right[node] == -1:
            starts.append(s)
            ends.append(e)
            mns.append(bvh.mn[node])
            mxs.append(bvh.mx[node])
            continue
        stack.append(bvh.right[node])  # pop order: left first (preorder)
        stack.append(bvh.left[node])
    return ClusterCut(
        starts=np.asarray(starts, np.int32),
        ends=np.asarray(ends, np.int32),
        mn=np.stack(mns).astype(np.float32),
        mx=np.stack(mxs).astype(np.float32),
    )
