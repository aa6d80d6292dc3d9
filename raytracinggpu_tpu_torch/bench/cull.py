"""Hard inputs and the bound of the pairs culling kernels (``csrc/cull.cu``:
``pair_bits`` and ``compact_key``, ``ops/_kernels.py``).

``adversarial`` makes seeded rays and boxes on which a slab test is easy
to get wrong: direction components of exactly +0.0 and -0.0 (``1/u`` is
+-inf, and ``(lo - O) * inf`` is NaN where the origin lies in the box's
plane), origins on box faces and corners, boxes of zero thickness on one
axis or all three, inverted boxes, and caps at exactly a box's enter
distance.  tests/test_torch_cull.py holds the plain versions to the JAX
package's on them, tests/test_torch_kernels.py and chip_smoke.py the
kernels to the plain versions.

``bound_ms`` is the least time the card could take for one call (see
the on-chip bound of chip_smoke.py): every slab test's operations at the
f32 peak, or every input read and every output written once at the
memory rate, whichever is larger.
"""
from __future__ import annotations

import numpy as np

# One slab test: per axis two subtractions, two multiplies and four
# min/max (the comparisons and ands of the hit are not counted, as the
# Moller-Trumbore tests' are not); a ray's three reciprocals are counted
# once.
SLAB_OPS = 24
PEAK_F32_FLOPS = 67e12  # NVIDIA H100 SXM data sheet, f32 without tensor cores
PEAK_BYTES_S = 3.35e12  # its HBM3


def adversarial(seed: int, R: int, n_boxes: int, n_tiles: int):
    """(O (3, R), u (3, R), boxes (n_boxes, 8), tiles (n_boxes,), cap (R,),
    active (R,)) as numpy: f32 rows, int32 tiles in [0, n_tiles) with tile
    31 among them, bool active.

    Coordinates lie on a grid of quarters, so that origins sit exactly on
    box planes; a quarter of the direction components are exactly +0.0 or
    -0.0; a quarter of the boxes are flat on one axis and a few are points
    or inverted; a quarter of the origins lie on a box's face and some on
    its corner; a tenth of the caps are the ray's exact enter distance of
    a box (as the slab test computes it), some are 0."""
    rng = np.random.default_rng(seed)
    q = lambda lo, hi, *shape: (rng.integers(lo * 4, hi * 4 + 1, shape)
                                / 4.0).astype(np.float32)
    lo = q(-6, 5, n_boxes, 3)
    hi = lo + q(0, 3, n_boxes, 3)
    flat = rng.random(n_boxes) < 0.25
    ax = rng.integers(0, 3, n_boxes)
    hi[flat, ax[flat]] = lo[flat, ax[flat]]
    point = rng.random(n_boxes) < 0.05
    hi[point] = lo[point]
    inv = rng.random(n_boxes) < 0.03
    lo[inv], hi[inv] = hi[inv].copy(), lo[inv].copy()
    boxes = np.zeros((n_boxes, 8), np.float32)
    boxes[:, 0:3], boxes[:, 3:6] = lo, hi
    tiles = rng.integers(0, n_tiles, n_boxes).astype(np.int32)
    tiles[rng.integers(0, n_boxes)] = min(31, n_tiles - 1)

    O = q(-8, 8, 3, R)
    which = rng.integers(0, n_boxes, R)
    face = rng.random(R) < 0.25
    corner = rng.random(R) < 0.05
    for i in np.flatnonzero(face | corner):
        b = which[i]
        inside = lo[b] + (hi[b] - lo[b]) * np.float32(0.5)
        side = np.where(rng.random(3) < 0.5, lo[b], hi[b])
        if corner[i]:
            O[:, i] = side
        else:
            a = rng.integers(0, 3)
            O[:, i] = inside
            O[a, i] = side[a]
    d = rng.normal(size=(3, R)).astype(np.float32)
    zero = rng.random((3, R)) < 0.25
    d[zero] = np.where(rng.random(int(zero.sum())) < 0.5, np.float32(0.0),
                       np.float32(-0.0))
    axis = rng.random(R) < 0.05  # two zero components: along an axis
    a = rng.integers(0, 3, R)
    for k in range(3):
        d[k, axis & (a != k)] = np.float32(0.0)
        d[k, axis & (a == k)] = np.where(rng.random(int((axis & (a == k))
                                                         .sum())) < 0.5,
                                         1.0, -1.0)
    none = ~d.any(axis=0)  # keep each ray a direction
    d[0, none] = 1.0

    cap = q(0, 8, R)
    cap[rng.random(R) < 0.05] = 0.0
    hit_cap = np.flatnonzero(rng.random(R) < 0.1)
    cap[hit_cap] = enter_of(O[:, hit_cap], d[:, hit_cap], boxes[which[hit_cap]])
    active = rng.random(R) < 0.8
    return O, d, boxes, tiles, cap, active


def enter_of(O, u, boxes):
    """Each ray's slab enter distance into its own box (column i of O and
    u against row i of boxes), in f32 with NaN propagated as the slab test
    of ``ops/pallas_trace.slab_enter_exit`` computes it."""
    enter = np.full(O.shape[1], -np.float32(3.4e38), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(3):
            rc = np.float32(1.0) / u[k]
            t0 = (boxes[:, k] - O[k]) * rc
            t1 = (boxes[:, 3 + k] - O[k]) * rc
            enter = np.maximum(enter, np.minimum(t0, t1))
    return enter.astype(np.float32)


def bound_ms(R: int, n_boxes: int, extra_in: int, out_bytes: int):
    """(ms, "operations" or "bytes") of one call over R rays and n_boxes
    boxes: R * n_boxes slab tests and 3 R reciprocals at PEAK_F32_FLOPS,
    or the rays' six f32 rows, ``extra_in`` more input bytes (cap, active,
    the boxes and their tiles) and ``out_bytes`` at PEAK_BYTES_S."""
    ops_s = (R * n_boxes * SLAB_OPS + 3 * R) / PEAK_F32_FLOPS
    bytes_s = (24 * R + extra_in + out_bytes) / PEAK_BYTES_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes")
