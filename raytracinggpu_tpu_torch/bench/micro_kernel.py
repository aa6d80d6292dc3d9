"""In-kernel primitive cost measurements on the card (port of
``raytracinggpu_tpu/bench/micro_kernel.py``).

Five probes price the building blocks of a fused cast kernel on Hopper,
each a hand-written CUDA kernel (``csrc/micro_kernel.cu``, launched by
``ops/_kernels.py``) with its plain PyTorch version beside it here:

- ``slope`` (B7a, ``bench_tile_slope``): a cast in which every 64-ray
  subgroup visits L listed tiles, L in {0, 1, 2, 4, 8}: the marginal cost
  of one (subgroup, tile) visit of 64 x 128 Moller-Trumbore tests, and
  the fixed cost of a cast with none (the launch floor);
- ``dma`` (B7b, ``bench_dma_smem``): each 1024-ray block computes a
  (32, 16) mask with its threads, publishes it through shared memory and
  bounds a loop with two scalars read back from it, against a control
  that only writes 2 x: can a block cull for itself?
- ``branch`` (B7c, ``bench_scalar_branch``): 8 fixed tiles, each visited
  under a per-(subgroup, tile) predicate, all true and a quarter true:
  what a warp-uniform skip costs;
- ``gather`` (B7d, ``bench_inkernel_gather``): out[i] = table[idx[i]], a
  data-dependent gather of 512-byte rows from a 1 MB table;
- ``pairslope`` (B7e, ``bench_pair_slope``): each 1024-ray block walks
  one flat list of (subgroup, tile) pairs, at subgroups of 8, 16, 32 and
  64 rays and L in {0, 1, 2, 4} pairs a subgroup: what a pair costs, and
  whether subgroups below a warp cost more a test.

    python -m raytracinggpu_tpu_torch.bench.micro_kernel \
        [--only slope,pairslope] [--rays N] [--iters N] [--device cpu]

Inputs come from a seeded generator.  On the card every timed kernel
output is held against the plain version bit for bit (a min of f32 values
is exact in any order); a probe that fails to build, launch or match
raises, and the command exits nonzero.  A CPU tensor runs the plain
version (``--device cpu``, for the tests; its times say nothing of the
card).  Times are CUDA-event means over ``--iters`` launches replayed
from one CUDA graph, raised until the replay spans milliseconds: launched
one by one from Python a kernel cannot be told from the host's cost of a
launch, which B7a's intercept line prints beside the kernel's own.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from raytracinggpu_tpu_torch.api import render_device
from raytracinggpu_tpu_torch.bench._timing import card_line, timed
from raytracinggpu_tpu_torch.ops._kernels import PROBE_BLK as BLK
from raytracinggpu_tpu_torch.ops._kernels import PROBE_FIXED as N_FIXED
from raytracinggpu_tpu_torch.ops._kernels import PROBE_SUBG as SUBG
from raytracinggpu_tpu_torch.ops._kernels import TILE_T as TILE
from raytracinggpu_tpu_torch.ops.pallas_trace import dispatch

# BLK: rays per block of the pair lists and of B7b (1024); TILE: triangles
# per tile (128); SUBG: rays per subgroup of B7a and B7c (64); N_FIXED:
# tiles of B7c, and the most B7a lists (8)
NF = 16         # ray features, triangle field rows
N_TILES = 31    # tiles of the entry point's table (the JAX probe's)
MISS = 1e9      # t where nothing was hit (exact in f32)
EPS = float(np.float32(1e-4))
GATHER_ROWS = 2048
# Elements of one (rays x 128) intermediate in the plain versions.
_PLAIN_ELEMS = 1 << 24
_MIN_SPAN_S = 2e-3  # a timed loop must span at least this


# ----------------------------------------------------------- plain versions

def _mt(rf, tile):
    """Moller-Trumbore of rays rf (..., n, 16) against triangles tile
    (16, ..., 128): t where the triangle is hit, else 1e9, (..., n, 128).
    Every sum left to right, a reciprocal and multiplies, as the kernels'
    ``mt_test`` (``csrc/mt.cuh``)."""
    col = lambda k: rf[..., k:k + 1]
    row = lambda k: tile[k][..., None, :]
    ux, uy, uz, wx, wy, wz, Ox, Oy, Oz = (col(k) for k in range(9))
    denom = ux * row(0) + uy * row(1) + uz * row(2)
    bnum = (ux * row(3) + uy * row(4) + uz * row(5)) - (
        wx * row(6) + wy * row(7) + wz * row(8))
    gnum = (wx * row(12) + wy * row(13) + wz * row(14)) - (
        ux * row(9) + uy * row(10) + uz * row(11))
    tnum = row(15) - (Ox * row(0) + Oy * row(1) + Oz * row(2))
    rden = 1.0 / denom
    beta = bnum * rden
    gamma = gnum * rden
    tval = tnum * rden
    ok = (torch.minimum(torch.minimum(beta, gamma), 1.0 - beta - gamma)
          >= 0.0) & (tval > EPS)
    return torch.where(ok, tval, MISS)


def _mt_pass(rf, tri, rows, off):
    """One (rows x 128) pass: rays ``rf[rows]`` over the tile starting at
    column ``off`` of ``tri`` (the JAX probe's ``_mt_pass``)."""
    return _mt(rf[rows], tri[:, off:off + TILE])


def _min_over_visits(rf, tri, subg, tile_ids, on):
    """t (R / 128, 128): per ray the min of the pass over tile
    ``tile_ids[sg, k]`` for every k with ``on[sg, k]``, sg its subgroup;
    ids outside the table are skipped."""
    R, n_tiles = rf.shape[0], tri.shape[1] // TILE
    S = R // subg
    tiles = tri.reshape(NF, n_tiles, TILE)
    rays = rf.reshape(S, subg, NF)
    tile_ids = tile_ids.long()
    on = on & (tile_ids >= 0) & (tile_ids < n_tiles)
    tile_ids = tile_ids.clamp(0, n_tiles - 1)
    t = torch.full((S, subg), MISS, dtype=torch.float32, device=rf.device)
    step = max(1, _PLAIN_ELEMS // (subg * TILE))
    for lo in range(0, S, step):
        hi = min(lo + step, S)
        for k in range(tile_ids.shape[1]):
            sel = on[lo:hi, k]
            if not bool(sel.any()):
                continue
            tk = _mt(rays[lo:hi], tiles[:, tile_ids[lo:hi, k]]).amin(dim=2)
            t[lo:hi] = torch.where(sel[:, None],
                                   torch.minimum(t[lo:hi], tk), t[lo:hi])
    return t.reshape(R // TILE, TILE)


def tile_slope_plain(lists, rf, tri):
    """Plain B7a.  lists (R / 64, Lw) i32 rows [count, tile ids...]."""
    pos = torch.arange(lists.shape[1] - 1, device=lists.device)
    on = pos[None, :] < lists[:, :1]
    return _min_over_visits(rf, tri, SUBG, lists[:, 1:], on)


def uniform_branch_plain(mask, rf, tri):
    """Plain B7c.  mask (R / 64, Mw) i32: tile j < 8 is visited iff
    mask[sg, j] > 0."""
    ids = torch.arange(N_FIXED, device=mask.device).expand(mask.shape[0],
                                                           N_FIXED)
    return _min_over_visits(rf, tri, SUBG, ids, mask[:, :N_FIXED] > 0)


def block_mask_plain(x, mask=True):
    """Plain B7b and its control: 2 x (the mask changes no output)."""
    return x * 2.0


def row_gather_plain(idx, table):
    """Plain B7d, the one PyTorch call that computes it."""
    return table[idx[:, 0].long()]


def pair_slope_plain(pairs, rf, tri, subg):
    """Plain B7e.  pairs (R / 1024, Pw) i32 rows [count, sg * 256 +
    tile, ...]; walks the list positions in order, one pair of every block
    at a time.  Pairs naming a subgroup or tile outside the block or the
    table are skipped."""
    R, n_tiles = rf.shape[0], tri.shape[1] // TILE
    B, n_sg = R // BLK, BLK // subg
    tiles = tri.reshape(NF, n_tiles, TILE)
    rays = rf.reshape(B, n_sg, subg, NF)
    t = torch.full((B, n_sg, subg), MISS, dtype=torch.float32,
                   device=rf.device)
    count = pairs[:, 0].clamp(max=pairs.shape[1] - 1)
    blocks = torch.arange(B, device=rf.device)
    for k in range(int(count.max()) if B else 0):
        p = pairs[:, 1 + k].long()
        sg, tile = p >> 8, p & 255
        on = (k < count) & (p >= 0) & (sg < n_sg) & (tile < n_tiles)
        sg, tile = sg.clamp(0, n_sg - 1), tile.clamp(0, n_tiles - 1)
        tk = _mt(rays[blocks, sg], tiles[:, tile]).amin(dim=2)
        old = t[blocks, sg]
        t[blocks, sg] = torch.where(on[:, None], torch.minimum(old, tk), old)
    return t.reshape(R // TILE, TILE)


# ------------------------------------------------- kernels on the card

def tile_slope(lists, rf, tri):
    """B7a on the tensors' device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    return dispatch("probe_tile_slope", tile_slope_plain, lists, rf, tri)


def uniform_branch(mask, rf, tri):
    """B7c on the tensors' device (see tile_slope)."""
    return dispatch("probe_uniform_branch", uniform_branch_plain, mask, rf,
                    tri)


def block_mask(x, mask=True):
    """B7b (``mask=False``: its control) on the tensor's device."""
    return dispatch("probe_block_mask", block_mask_plain, x, mask)


def row_gather(idx, table):
    """B7d on the tensors' device."""
    return dispatch("probe_row_gather", row_gather_plain, idx, table)


def pair_slope(pairs, rf, tri, subg):
    """B7e on the tensors' device."""
    return dispatch("probe_pair_slope", pair_slope_plain, pairs, rf, tri,
                    subg)


# ------------------------------------------------------------------ inputs

def cast_inputs(R, n_tiles, seed, device):
    """Seeded rf (R, 16) and tri (16, n_tiles * 128), uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    rf = rng.random((R, NF), dtype=np.float32)
    tri = rng.random((NF, n_tiles * TILE), dtype=np.float32)
    return torch.from_numpy(rf).to(device), torch.from_numpy(tri).to(device)


def tile_lists(R, L, device):
    """Every subgroup lists tiles 0 .. L-1: rows [L, 0, 1, ..., pad]."""
    lists = np.zeros((R // SUBG, TILE), np.int32)
    lists[:, 0] = L
    lists[:, 1:1 + L] = np.arange(L)
    return torch.from_numpy(lists).to(device)


def pair_lists(R, n_tiles, subg, L, device):
    """Every block's flat list: subgroup sg pairs with tiles (sg + j) mod
    n_tiles, j < L, subgroup-major: rows [n_sg * L, sg * 256 + tile, ...]."""
    n_sg = BLK // subg
    row = np.zeros(1 + max(n_sg * min(L + 1, n_tiles), 8), np.int32)
    row[0] = n_sg * L
    sg, j = np.divmod(np.arange(n_sg * L), max(L, 1))
    row[1:1 + n_sg * L] = sg * 256 + (sg + j) % n_tiles
    return torch.from_numpy(np.tile(row, (R // BLK, 1))).to(device)


# ------------------------------------------------------------ the benches

BENCHES = ("pairslope", "slope", "dma", "branch", "gather")


def _rays(R, n_tiles=N_FIXED):
    if R <= 0 or R % BLK:
        raise ValueError(f"--rays must be a positive multiple of {BLK}, "
                         f"got {R}")
    if n_tiles < N_FIXED:
        raise ValueError(f"the probes visit up to {N_FIXED} tiles, got "
                         f"{n_tiles}")


def cases(R, n_tiles, device, seed=0, only=BENCHES):
    """Every configuration of the probes named by ``only`` at R rays and
    n_tiles tiles, inputs from ``seed``: dicts of "probe" (its name in
    BENCHES), "kernel" (its wrapper in ops/_kernels), "label", "run" and
    "plain" (the two versions, called on "args"), the work it does,
    "tests" (MT tests) and "nbytes" (each input read and each output
    written once), and the probe's own parameters."""
    _rays(R, n_tiles)
    rf, tri = cast_inputs(R, n_tiles, seed, device)
    cast_bytes = lambda rows, tiles: 4 * (rows.numel() + R * 9
                                          + NF * tiles * TILE + R)
    if "pairslope" in only:
        for subg in (8, 16, 32, 64):
            for L in (0, 1, 2, 4):
                pairs = pair_lists(R, n_tiles, subg, L, device)
                n_pairs = (R // subg) * L
                touched = min(n_tiles, BLK // subg + L - 1) if L else 0
                yield dict(probe="pairslope", kernel="probe_pair_slope",
                           label=f"pair_slope subg={subg} L={L}",
                           run=pair_slope, plain=pair_slope_plain,
                           args=(pairs, rf, tri, subg), subg=subg, L=L,
                           pairs=n_pairs, tests=n_pairs * subg * TILE,
                           nbytes=cast_bytes(pairs, touched))
    if "slope" in only:
        for L in (0, 1, 2, 4, 8):
            lists = tile_lists(R, L, device)
            visits = (R // SUBG) * L
            yield dict(probe="slope", kernel="probe_tile_slope",
                       label=f"tile_slope L={L}", run=tile_slope,
                       plain=tile_slope_plain, args=(lists, rf, tri), L=L,
                       visits=visits, tests=visits * SUBG * TILE,
                       nbytes=cast_bytes(lists, L))
    if "dma" in only:
        for mask in (True, False):
            yield dict(probe="dma", kernel="probe_block_mask",
                       label="dma_smem" + ("" if mask else " control"),
                       run=block_mask, plain=block_mask_plain,
                       args=(rf, mask), mask=mask, tests=0,
                       nbytes=2 * rf.numel() * 4)
    if "branch" in only:
        rng = np.random.default_rng(seed + 1)
        for frac, name in ((1.0, "all_true"), (0.25, "quarter_true")):
            m = (rng.random((R // SUBG, TILE)) < frac).astype(np.int32)
            mask = torch.from_numpy(m).to(device)
            visits = int(m[:, :N_FIXED].sum())
            yield dict(probe="branch", kernel="probe_uniform_branch",
                       label=f"scalar_branch[{name}]", run=uniform_branch,
                       plain=uniform_branch_plain, args=(mask, rf, tri),
                       name=name, visits=visits,
                       tests=visits * SUBG * TILE,
                       nbytes=cast_bytes(mask, N_FIXED))
    if "gather" in only:
        rng = np.random.default_rng(seed)
        table = torch.from_numpy(rng.random((GATHER_ROWS, TILE),
                                            dtype=np.float32)).to(device)
        idx = torch.from_numpy(rng.integers(0, GATHER_ROWS, (R, 1))
                               .astype(np.int32)).to(device)
        yield dict(probe="gather", kernel="probe_row_gather",
                   label="inkernel_gather_rows", run=row_gather,
                   plain=row_gather_plain, args=(idx, table), tests=0,
                   nbytes=4 * (idx.numel() + table.numel() + R * TILE))


def _measure(case, iters, dev, eager=False):
    """Time one case: the case with "s", "plain_s" and "out" (with
    ``eager``, "eager_s" too).  On the card "s" is a launch replayed from
    a CUDA graph of ``iters`` launches, raised until the replay spans
    milliseconds: the kernel's own time; "eager_s" is a launch from Python,
    which the host's cost of a launch bounds from below; the output must
    equal the plain version's bit for bit, and "plain_s" is one run of it
    after one warm-up run.  On the CPU "s" is the host's time of the plain
    version (the kernel is the plain version) and nothing is compared."""
    run = lambda: case["run"](*case["args"])
    out = run()
    if dev.type != "cuda":
        dt = timed(run, iters, device=dev)
        return dict(case, s=dt, plain_s=None, out=out,
                    **(dict(eager_s=dt) if eager else {}))
    dt = timed(run, iters, device=dev, graph=True)
    if dt * iters < _MIN_SPAN_S:
        n = min(100 * iters, math.ceil(_MIN_SPAN_S / max(dt, 1e-9)))
        dt = timed(run, n, device=dev, graph=True)
    want = []
    plain_s = timed(lambda: want.append(case["plain"](*case["args"])), 1,
                    warm=1, device=dev)
    if not torch.equal(out, want[-1]):
        bad = int((out != want[-1]).sum())
        raise RuntimeError(f"{case['label']}: the kernel differs from its "
                           f"plain version on {bad} of {out.numel()} values")
    res = dict(case, s=dt, plain_s=plain_s, out=out)
    if eager:
        res["eager_s"] = timed(run, iters, device=dev)
    return res


def bench_tile_slope(R, n_tiles, iters, device=None, seed=0):
    """B7a: cost against visits a subgroup.  Returns one measured case per
    L (``cases``, ``_measure``)."""
    dev = render_device(device)
    res = []
    for c in cases(R, n_tiles, dev, seed, ("slope",)):
        m = _measure(c, iters, dev, eager=c["L"] == 0)
        res.append(m)
        line = f"{m['label']}: {m['s'] * 1e3:8.4f} ms"
        if m["L"]:
            per = (m["s"] - res[0]["s"]) / m["visits"]
            line += (f"  marginal {per * 1e9:7.2f} ns a visit, "
                     f"{per * 1e12 / (SUBG * TILE):6.3f} ps an MT test")
        else:
            line += ("  (intercept: a cast with no visit, the launch floor; "
                     f"launched from Python {m['eager_s'] * 1e6:.2f} us)")
        print(line, flush=True)
    return res


def bench_dma_smem(R, iters, device=None, seed=0):
    """B7b: the in-kernel mask against its control.  Returns the mask
    kernel's measured case, with "control_s"."""
    dev = render_device(device)
    m, ctl = (_measure(c, iters, dev)
              for c in cases(R, N_FIXED, dev, seed, ("dma",)))
    per_blk = (m["s"] - ctl["s"]) / (R // BLK)
    print(f"dma_smem: with={m['s'] * 1e3:.4f} ms  control="
          f"{ctl['s'] * 1e3:.4f} ms  marginal {per_blk * 1e6:.4f} us a block "
          f"({R // BLK} blocks)", flush=True)
    return dict(m, control_s=ctl["s"])


def bench_scalar_branch(R, n_tiles, iters, device=None, seed=0):
    """B7c: 8 fixed tiles under a per-(subgroup, tile) predicate.  Returns
    one measured case per mask."""
    dev = render_device(device)
    res = []
    for c in cases(R, n_tiles, dev, seed, ("branch",)):
        m = _measure(c, iters, dev)
        res.append(m)
        print(f"{m['label']}: {m['s'] * 1e3:8.4f} ms  ({m['visits']} "
              f"active of {(R // SUBG) * N_FIXED}, "
              f"{m['s'] * 1e12 / max(m['tests'], 1):.3f} ps an MT test)",
              flush=True)
    return res


def bench_inkernel_gather(R, iters, device=None, seed=0):
    """B7d: the row gather.  Returns its measured case; the plain version
    is the library call."""
    dev = render_device(device)
    (c,) = cases(R, N_FIXED, dev, seed, ("gather",))
    m = _measure(c, iters, dev)
    dt = m["s"]
    print(f"{m['label']}: {dt * 1e3:.4f} ms  ({dt / R * 1e9:.3f} ns a "
          f"row, {m['nbytes'] / dt / 1e9:.1f} GB/s)", flush=True)
    return m


def bench_pair_slope(R, n_tiles, iters, device=None, seed=0):
    """B7e: one flat (subgroup, tile) pair list a block.  Returns one
    measured case per (subgroup, L)."""
    dev = render_device(device)
    res = []
    for c in cases(R, n_tiles, dev, seed, ("pairslope",)):
        m = _measure(c, iters, dev)
        res.append(m)
        dt, subg, L = m["s"], m["subg"], m["L"]
        if L == 0:
            base = dt
            print(f"{m['label']}: {dt * 1e3:8.4f} ms (intercept)", flush=True)
        else:
            per = (dt - base) / m["pairs"]
            print(f"{m['label']}: {dt * 1e3:8.4f} ms  "
                  f"marginal {per * 1e9:7.2f} ns a pair, "
                  f"{per * m['pairs'] / R * 1e9:6.2f} ns a ray, "
                  f"{per * 1e12 / (subg * TILE):6.3f} ps an MT test",
                  flush=True)
    return res


def main(argv=None) -> dict:
    """Run the probes named by ``--only`` (all by default); returns
    {probe: what its bench returned}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rays", type=int, default=131072)
    ap.add_argument("--only", type=str, default=None,
                    help=f"comma-separated subset of {','.join(BENCHES)}")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    a = ap.parse_args(argv)
    only = a.only.split(",") if a.only else BENCHES
    unknown = sorted(set(only) - set(BENCHES))
    if unknown:
        ap.error(f"unknown probes {unknown}; choose from {BENCHES}")
    dev = render_device(a.device)
    if dev.type == "cuda":
        print(f"card: {card_line()}; {a.rays} rays, {N_TILES} tiles, "
              f"{a.iters} iterations", flush=True)
    todo = {
        "pairslope": lambda: bench_pair_slope(a.rays, N_TILES, a.iters, dev),
        "slope": lambda: bench_tile_slope(a.rays, N_TILES, a.iters, dev),
        "dma": lambda: bench_dma_smem(a.rays, a.iters, dev),
        "branch": lambda: bench_scalar_branch(a.rays, N_TILES, a.iters, dev),
        "gather": lambda: bench_inkernel_gather(a.rays, a.iters, dev),
    }
    return {name: todo[name]() for name in BENCHES if name in only}


if __name__ == "__main__":
    main()
