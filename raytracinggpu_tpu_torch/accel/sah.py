"""Binned surface-area-heuristic BVH builder, host numpy (port of
``raytracinggpu_tpu/accel/sah.py``).

Not a reference-parity component: an optional CLUSTER TREE for
``build_pairs_tables(ids_map=...)``.  Midpoint subtree boxes overlap and
elongate; a SAH tree tightens the cluster cut's member boxes, which cuts
false-positive tile activations.  Slot ids stay in the canonical mesh
(reference-BVH) order through ``ids_map``, so the closest hit's
lexicographic (t, id) tie-break is unchanged and swapping cluster trees
renders bit-identically.

Standard binned SAH: at each node the centroids are binned along each
axis (n_bins), the split plane minimizes SA(left)*N(left) +
SA(right)*N(right), with an object-median fallback when the centroid
bounds degenerate.  Nodes split until max_leaf.  The code is the JAX
package's, so the tree (``order`` included) is bitwise its tree.
"""
from __future__ import annotations

import sys

import numpy as np

from raytracinggpu_tpu_torch.accel.bvh import FlatBVH, _compute_skip_links


def _half_area(mn: np.ndarray, mx: np.ndarray) -> float:
    d = np.maximum(mx - mn, 0.0)
    return float(d[0] * d[1] + d[1] * d[2] + d[2] * d[0])


def build_sah_bvh(A, B, C, max_leaf: int = 8, n_bins: int = 16) -> FlatBVH:
    """Build a binned-SAH tree over triangle corner arrays (T, 3).

    Returns a FlatBVH whose ``order`` maps tree triangle positions back to
    positions in the INPUT arrays (for build_pairs_tables the canonical
    mesh order, so ``order`` doubles as the ids_map)."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    # per-triangle boxes over all three corners and f32 centroids
    tmn = np.minimum(np.minimum(A, B), C)
    tmx = np.maximum(np.maximum(A, B), C)
    cen = (A + B + C) / 3.0

    order = np.arange(T)
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
        mn = tmn[ids].min(axis=0)
        mx = tmx[ids].max(axis=0)
        starts[node], ends[node] = s, e
        mns[node], mxs[node] = mn, mx
        n = e - s
        if n <= max_leaf:
            return

        cmn = cen[ids].min(axis=0)
        cmx = cen[ids].max(axis=0)
        ext = cmx - cmn
        best = None  # (cost, axis, boolean mask of "left" per position)
        for axis in range(3):
            if ext[axis] <= 0.0:
                continue
            # bin the centroids; prefix/suffix sweep of the bin boxes
            t = (cen[ids, axis] - cmn[axis]) * (n_bins / ext[axis])
            b = np.clip(t.astype(np.int64), 0, n_bins - 1)
            counts = np.bincount(b, minlength=n_bins)
            bmn = np.full((n_bins, 3), np.inf, np.float32)
            bmx = np.full((n_bins, 3), -np.inf, np.float32)
            for k in np.unique(b):
                sel = ids[b == k]
                bmn[k] = tmn[sel].min(axis=0)
                bmx[k] = tmx[sel].max(axis=0)
            lmn = np.minimum.accumulate(bmn, axis=0)
            lmx = np.maximum.accumulate(bmx, axis=0)
            rmn = np.minimum.accumulate(bmn[::-1], axis=0)[::-1]
            rmx = np.maximum.accumulate(bmx[::-1], axis=0)[::-1]
            lcnt = np.cumsum(counts)
            for k in range(n_bins - 1):
                nl = int(lcnt[k])
                nr = n - nl
                if nl == 0 or nr == 0:
                    continue
                cost = nl * _half_area(lmn[k], lmx[k]) + nr * _half_area(
                    rmn[k + 1], rmx[k + 1])
                if best is None or cost < best[0]:
                    best = (cost, axis, b <= k)
        if best is None:
            # degenerate centroid bounds on every axis: object-median split
            # on the longest node axis keeps the leaves bounded
            axis = int(np.argmax(mx - mn))
            key = np.argsort(cen[ids, axis], kind="stable")
            half = n // 2
            lmask = np.zeros(n, bool)
            lmask[key[:half]] = True
        else:
            lmask = best[2]
            if not (0 < lmask.sum() < n):  # never emit an empty child
                key = np.argsort(cen[ids, best[1]], kind="stable")
                lmask = np.zeros(n, bool)
                lmask[key[: n // 2]] = True
        # stable two-sided partition (order within each side preserved)
        order[s:e] = np.concatenate([ids[lmask], ids[~lmask]])
        pivot = s + int(lmask.sum())
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
