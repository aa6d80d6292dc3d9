"""Hard inputs and the bound of the culling kernels (``csrc/cull.cu``:
``pair_bits``, ``compact_key`` and ``compact_bits`` of the pairs
traversal, ``tile_lists`` of the tiled one; ``ops/_kernels.py``).

``adversarial`` makes seeded rays and boxes on which a slab test is easy
to get wrong: direction components of exactly +0.0 and -0.0 (``1/u`` is
+-inf, and ``(lo - O) * inf`` is NaN where the origin lies in the box's
plane), origins on box faces and corners, boxes of zero thickness on one
axis or all three, inverted boxes, and caps at exactly a box's enter
distance; ``adversarial_tiles`` makes a tiled table of such boxes with
the padding tiles' inverted boxes and NaN in lo.x, hi.x and another
coordinate.  tests/test_torch_cull.py and tests/test_torch_tile_cull.py
hold the plain versions to the JAX package's on them,
tests/test_torch_kernels.py and chip_smoke.py the kernels to the plain
versions.

``bound_ms`` is the least time the card could take for one call (see
the on-chip bound of chip_smoke.py): every slab test's operations at the
f32 peak, or every input read and every output written once at the
memory rate, whichever is larger.  It also gives the no-FMA floor: the
f32 peak counts an FMA as two operations, and a slab test has none (its
products are rounded alone), so a lane retires one of its operations a
cycle: the same operations at half the peak, the bytes term unchanged.
``call_bound`` counts both for one call of a culling kernel.
"""
from __future__ import annotations

import numpy as np

# One slab test: per axis two subtractions, two multiplies and four
# min/max (the comparisons and ands of the hit are not counted, as the
# Moller-Trumbore tests' are not); a ray's three reciprocals are counted
# once.
SLAB_OPS = 24
PEAK_F32_FLOPS = 67e12  # NVIDIA H100 SXM data sheet, f32 without tensor cores
NO_FMA_OPS_S = PEAK_F32_FLOPS / 2  # an FMA counts two; a slab test has none
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


def adversarial_tiles(seed: int, R: int, n_tiles: int):
    """(O (3, R), u (3, R), aabb (n_tiles, 8), cap (R,)) as numpy: the rays
    and boxes of ``adversarial`` as a tiled table (box t is tile t), with
    what a tiled table adds: padding tiles' inverted box (lo = +INF, hi =
    -INF, INF = 1e9 + 9, as ``ops/pallas_trace.build_pallas_tables`` writes
    it) on the last eighth of the tiles and the middle one (from 4 tiles),
    and, where a quarter of the other tiles is at least 4, a NaN in lo.x,
    a NaN in hi.x (both invalid boxes), a NaN in another coordinate (a box
    no ray hits) and a box from -inf to +inf (one every ray hits)."""
    O, d, boxes, _, cap, _ = adversarial(seed, R, n_tiles, n_tiles)
    rng = np.random.default_rng(seed + 1000)
    pad = set(range(n_tiles - n_tiles // 8, n_tiles))
    if n_tiles >= 4:
        pad.add(n_tiles // 2)
    pad = sorted(pad)
    boxes[pad, 0:3] = np.float32(1e9 + 9)
    boxes[pad, 3:6] = -np.float32(1e9 + 9)
    rest = np.setdiff1d(np.arange(n_tiles), pad)
    if rest.size // 4 >= 4:
        a, b, c, e = rng.choice(rest, 4, replace=False)
        boxes[a, 0] = np.nan
        boxes[b, 3] = np.nan
        boxes[c, rng.choice([1, 2, 4, 5])] = np.nan
        boxes[e, 0:3], boxes[e, 3:6] = -np.inf, np.inf
    return O, d, boxes, cap


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
    """(ms, "operations" or "bytes", no-FMA floor ms) of one call over R
    rays and n_boxes boxes: R * n_boxes slab tests and 3 R reciprocals at
    PEAK_F32_FLOPS, or the rays' six f32 rows, ``extra_in`` more input
    bytes (cap, active, the boxes and their tiles) and ``out_bytes`` at
    PEAK_BYTES_S; the floor takes the operations at half PEAK_F32_FLOPS."""
    ops = R * n_boxes * SLAB_OPS + 3 * R
    ops_s = ops / PEAK_F32_FLOPS
    bytes_s = (24 * R + extra_in + out_bytes) / PEAK_BYTES_S
    return (max(ops_s, bytes_s) * 1e3,
            "operations" if ops_s >= bytes_s else "bytes",
            max(ops / NO_FMA_OPS_S, bytes_s) * 1e3)


def call_bound(name: str, args, out):
    """``bound_ms`` of one call of ``ops/pairs_trace._pair_bits`` (name
    "pair_bits", args (O, u, nc, subg, (boxes, tiles), cap, active), out
    the bits), ``_compact_key`` ("compact_key", args (O, u, boxes, nc,
    cap, active, valid_n), out (skey, n_act, ...)) or
    ``ops/pallas_trace._block_active_tiles`` ("tile_lists", args (O, u,
    aabb, n_tiles, cap, subg), out the list rows) or
    ``ops/pairs_trace.compact_bits`` ("compact_bits", args (keys, C,
    shift, O, u, nc, subg, (boxes, tiles), cap, active), out (rows,
    active, bits)): its slab tests (for the lists, against the valid
    tiles' boxes only, the work these boxes need; for compact_bits on its
    C rays), and its inputs read and outputs written once (compact_bits:
    C keys and the C lanes' rays; its 6 C f64 operations, the cross
    product of the rows, take under 0.02 us at the cast sizes and are left
    out)."""
    active = None
    if name == "compact_bits":
        keys, C, _, _, _, _, _, (boxes, _), cap, active = args
        nb = boxes.shape[0]
        out_bytes = sum(x.numel() * x.element_size() for x in out
                        if x is not None)
        extra = 4 * C + nb * (6 + 1) * 4
        extra += (0 if cap is None else 4 * C) + (
            0 if active is None else C)
        return bound_ms(C, nb, extra, out_bytes)
    if name == "pair_bits":
        O, _, _, _, (boxes, _), cap, active = args
        nb, out_bytes = boxes.shape[0], out.numel() * 4
        extra = nb * (6 + 1) * 4
    elif name == "tile_lists":
        O, _, aabb, nt, cap, _ = args
        nb = int((aabb[:nt, 0] <= aabb[:nt, 3]).sum())
        out_bytes = out.numel() * 4
        extra = nt * 6 * 4
    else:
        O, _, _, nb, cap, active, _ = args
        out_bytes = out[0].numel() * 4 + 8
        extra = nb * 6 * 4
    R = O.x.shape[0]
    extra += (0 if cap is None else 4 * R) + (0 if active is None else R)
    return bound_ms(R, nb, extra, out_bytes)


# subgroups of index_cases: a warp, part of one, several, and a subgroup
# wider than the kernel's block
SUBGROUPS = (8, 16, 32, 64, 128, 512)
# the tiled traversal's subgroups (ops/pallas_trace._check_subg admits
# these) and a table past a block's 131,072 tiles of shared words
TILE_SUBGROUPS = (1, 2, 4, 8, 16, 32, 64, 128)
BIG_TABLE = 140_000
OUTSIDE = (-1, -2**31, 2**30)  # member tiles outside [0, nc) (+ nc itself)


def index_cases(device, n_sg: int = 37, seed: int = 2) -> list:
    """[(label, name, args, plain_args)]: calls of ops/pairs_trace's
    ``_pair_bits`` ("pair_bits", args (O, u, nc, subg, members, cap,
    active)) and ``_compact_key`` ("compact_key", args (O, u, boxes, nc,
    cap, active, valid_n)) on ``adversarial`` rays and boxes as tensors on
    ``device``, shaped to reach every branch of the kernels' index math;
    ``plain_args`` are the plain version's, whose result the kernel's must
    equal bit for bit:

    - pair_bits at each of SUBGROUPS over n_sg subgroups (an odd count,
      so the rays are no multiple of the rays a block holds), 1,100 member
      boxes (several staging chunks) in 300 tiles, plus members naming
      tiles outside [0, 300) (OUTSIDE and 300), which the kernel ignores
      and the plain version is not given; with cap and active, and at
      subgroups 16 and 128 without;
    - pair_bits over 5,000 tiles (157 words a subgroup, several passes of
      a block's words) at subgroups 2 and 8, 2,075 subgroups;
    - compact_key on 5,000 rays (no multiple of a block's), valid_n 4,993,
      over 40 boxes (mode 2), 129 (one past a staging chunk) and 1,100
      (mode 1);
    - tile_lists ("tile_lists", args (O, u, aabb, n_tiles, cap, subg) of
      ops/pallas_trace's ``_block_active_tiles``) on ``adversarial_tiles``
      tables: at each of TILE_SUBGROUPS over n_sg subgroups and 300
      tiles, with cap (and at subgroups 1 and 64 without); at subgroups
      1 and 8 over a 5,000-box table (157 words a subgroup, several
      passes of a block's words); at subgroups 1 and 64 over a
      BIG_TABLE-box table (past 131,072 tiles: 4,375 words, rows of
      140,001 ints), 7 and 449 subgroups."""
    import torch

    from raytracinggpu_tpu_torch.core.vec import Vec3

    def tensors(R, n_boxes, n_tiles, s):
        O, d, boxes, tiles, cap, act = adversarial(s, R, n_boxes, n_tiles)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return (Vec3(*map(t, O)), Vec3(*map(t, d)), t(boxes), t(tiles),
                t(cap), t(act))

    cases = []
    for i, subg in enumerate(SUBGROUPS):
        O, u, boxes, tiles, cap, act = tensors(subg * n_sg, 1100, 300,
                                               seed + i)
        out = torch.tensor((*OUTSIDE, 300), dtype=torch.int32, device=device)
        all_boxes = torch.cat([boxes, boxes[:out.shape[0]]])
        all_tiles = torch.cat([tiles, out])
        perm = torch.from_numpy(np.random.default_rng(seed + i).permutation(
            all_tiles.shape[0])).to(device)
        members = (all_boxes[perm].contiguous(), all_tiles[perm].contiguous())
        for c, a in ((cap, act),) + (((None, None),) if subg in (16, 128)
                                     else ()):
            tail = (c, a)
            cases.append((f"subgroup {subg}, {subg * n_sg} rays, 1,104 "
                          f"members (4 outside the 300 tiles), "
                          f"{'with' if c is not None else 'without'} cap "
                          "and active", "pair_bits",
                          (O, u, 300, subg, members, *tail),
                          (O, u, 300, subg, (boxes, tiles), *tail)))
    for subg in (2, 8):
        O, u, boxes, tiles, cap, act = tensors(subg * 2075, 1100, 5000,
                                               seed + subg)
        args = (O, u, 5000, subg, (boxes, tiles), cap, act)
        cases.append((f"subgroup {subg}, {subg * 2075} rays, 5,000 tiles",
                      "pair_bits", args, args))
    O, u, boxes, _, cap, act = tensors(5000, 1100, 300, seed + 20)
    for n in (40, 129, 1100):
        args = (O, u, boxes[:n].contiguous(), n, cap, act, 4993)
        cases.append((f"5,000 rays, valid 4,993, {n} key boxes",
                      "compact_key", args, args))

    def tiled(subg, n_sub, n_tiles, s, caps=(True,)):
        O, d, aabb, cap = adversarial_tiles(s, subg * n_sub, n_tiles)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        O, u, aabb, cap = Vec3(*map(t, O)), Vec3(*map(t, d)), t(aabb), t(cap)
        for c in caps:
            args = (O, u, aabb, n_tiles, cap if c else None, subg)
            cases.append((f"tile lists, subgroup {subg}, {subg * n_sub} "
                          f"rays, a {n_tiles:,}-box table, "
                          f"{'with' if c else 'without'} cap", "tile_lists",
                          args, args))

    for i, subg in enumerate(TILE_SUBGROUPS):
        tiled(subg, n_sg, 300, seed + 30 + i,
              (True, False) if subg in (1, 64) else (True,))
    for subg in (1, 8):
        tiled(subg, n_sg, 5000, seed + 40 + subg)
    tiled(64, 7, BIG_TABLE, seed + 50)
    tiled(1, 449, BIG_TABLE, seed + 51)
    return cases
