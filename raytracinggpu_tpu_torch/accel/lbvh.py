"""LBVH: linear BVH over Morton codes (port of
``raytracinggpu_tpu/accel/lbvh.py``).

``build_lbvh`` sorts the triangles by the Morton code of their centroid
(10 bits per axis over the mesh bounds) and splits each node at the first
code bit that divides its range, emitting the same flat preorder layout as
the reference midpoint builder (``accel/bvh.py``): left/right/mn/mx/
tri_start/tri_end, contiguous leaf ranges, the reordered triangle index
array and skip links.  The tree's shape differs from the midpoint
builder's; closest hits do not.  The pairs tables also pack BVH clusters
into tiles in Morton order of their box centers
(``ops/pairs_trace._cluster_slots``).
"""
from __future__ import annotations

import sys

import numpy as np

from raytracinggpu_tpu_torch.accel.bvh import (
    LEAF_MIN_TRIS,
    FlatBVH,
    _compute_skip_links,
)

MORTON_BITS = 10  # per axis -> 30-bit codes


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points, quantized over their bbox."""
    mn = points.min(axis=0)
    mx = points.max(axis=0)
    ext = np.maximum(mx - mn, 1e-9)
    q = ((points - mn) / ext * (2**MORTON_BITS - 1)).astype(np.uint32)
    q = np.clip(q, 0, 2**MORTON_BITS - 1)
    return (
        (_expand_bits(q[:, 0]) << np.uint32(2))
        | (_expand_bits(q[:, 1]) << np.uint32(1))
        | _expand_bits(q[:, 2])
    )


def build_lbvh(A: np.ndarray, B: np.ndarray, C: np.ndarray,
               leaf_size: int = LEAF_MIN_TRIS) -> FlatBVH:
    """Build the LBVH over triangle corners (T, 3); returns the same
    FlatBVH structure as ``build_bvh``."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    cen = (A + B + C) / 3.0
    codes = morton_codes(cen)
    order = np.argsort(codes, kind="stable")
    sorted_codes = codes[order]

    left, right, mns, mxs, starts, ends = [], [], [], [], [], []

    def emit() -> int:
        idx = len(left)
        for lst in (left, right, starts, ends):
            lst.append(-1)
        mns.append(None)
        mxs.append(None)
        return idx

    def bbox(s, e):
        ids = order[s:e]
        pts = np.concatenate([A[ids], B[ids], C[ids]], axis=0)
        return pts.min(axis=0), pts.max(axis=0)

    # the recursion is as deep as the code bits plus the median splits of
    # equal codes
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 10000))

    def split_pos(s: int, e: int, bit: int) -> tuple[int, int]:
        """First position in [s, e) whose code has `bit` set, scanning down
        from `bit` until a bit actually splits the range; returns
        (position, bit_used) or (s, -1) when codes are all equal."""
        while bit >= 0:
            mask = np.uint32(1 << bit)
            has = (sorted_codes[s:e] & mask) != 0
            p = int(np.searchsorted(has, True))  # has is sorted (0s then 1s)
            if 0 < p < e - s:
                return s + p, bit
            bit -= 1
        return s, -1

    def build(node: int, s: int, e: int, bit: int) -> None:
        starts[node], ends[node] = s, e
        mns[node], mxs[node] = bbox(s, e)
        if e - s < leaf_size:
            return
        p, used = split_pos(s, e, bit)
        if used < 0:
            # identical codes: a median split
            p = (s + e) // 2
            used = 0
        li = emit()
        left[node] = li
        build(li, s, p, used - 1)
        ri = emit()
        right[node] = ri
        build(ri, p, e, used - 1)

    root = emit()
    build(root, 0, T, 3 * MORTON_BITS - 1)

    flat = FlatBVH(
        left=np.asarray(left, np.int32),
        right=np.asarray(right, np.int32),
        mn=np.stack(mns).astype(np.float32),
        mx=np.stack(mxs).astype(np.float32),
        tri_start=np.asarray(starts, np.int32),
        tri_end=np.asarray(ends, np.int32),
        order=np.asarray(order),
        skip=np.zeros(len(left), np.int32),
    )
    _compute_skip_links(flat)
    return flat
