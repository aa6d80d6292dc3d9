"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits nonzero:

1. environment: the card's name and power limit (nvidia-smi), torch,
   CUDA and nvcc versions;
2. build: compile the hand-written kernels (csrc/pairs_trace.cu: B0-B3,
   csrc/pallas_trace.cu: B5, B6, csrc/micro_kernel.cu: the probes B7a-e)
   with nvcc for sm_90a, one process per source, and load them;
3. per-cast check: render the main-path frame (array_bvh, 512x512,
   spp 32, depth 5) once while keeping the inputs the frame gives each
   kernel at depths 0 and 1 of its first cast (4 samples fused, 524,288
   rays); on those inputs B1 and B2 must equal their plain PyTorch
   versions bit for bit, and so must B0, whose (t, idx) must also equal
   B1's on the closest casts;
4. headline frame: render the main-path frame through the public entry
   points with the launch counters zeroed just before; the image must be
   finite and equal the phase-3 frame (same seed), every ray must hit the
   enclosed scene at every depth, some shadow rays must be occluded, B1
   and B2 must have launched once per cast and B3 and B0 never; then time
   three frames and print Mray/s;
5. timings: each kernel against its plain version on the casts kept in
   phase 3, with ps a Moller-Trumbore test and the no-FMA floor (see
   NO_FMA_OPS_S) beside the bound;
6. production anchor: the 512x512 spp 8 depth 3 seed 0 frame's mean must
   lie within 1% of the JAX package's CPU render of the same frame; the
   JAX package's TPU record is printed beside it (see ANCHOR_* below);
7. realtime loop (the ``realtime`` preset, 512x512, spp 20, depth 3,
   seed 0; smooth normals, so every closest cast runs B3):
   a. the loop's first frame (``step`` from ``init_state``) with the
      inputs of B3's and B2's depth-0 and depth-1 casts kept; on them B3,
      B2 and B0 must equal their plain versions bit for bit, and B0's
      (t, idx) B3's; B3 must launch 30 times and B1 never;
   b. realtime anchor: the same frame through ``render_rows`` must equal
      the step's frame, hit the enclosed scene with every ray at every
      depth, and its mean must lie within 1% of the JAX package's CPU
      render (ANCHOR_RT_* below);
   c. ``run_loop`` over LOOP_FRAMES frames with the counters zeroed just
      before: B3 launched 30 times a frame and B1 never; frames, rng_frame
      and the light angle advanced; the image finite; the last display
      the tonemap of the average; ms per frame (the call's wall time over
      its frames), FPS and Mray/s printed;
   d. checkpoint: save, load and step reproduce the uninterrupted next
      frame bit for bit;
   e. timings of B3 and B0 against their plain versions on the kept casts;
8. mesh query: ``intersect_tris_pairs(payload=None)``, the public query,
   on the realtime frame's primary rays with the counters zeroed: it must
   launch B0 once and give B3's (t, idx) on the same rays;
9. the tiled-kernel traversal (``traversal="pallas"``, csrc/pallas_trace.cu:
   B5 closest hit, B6 shadow):
   a. the headline frame with traversal="pallas", the inputs of B5's and
      B6's depth-0 and depth-1 casts kept; on them B5 and B6 must equal
      their plain versions bit for bit;
   b. the same frame again with the counters zeroed: finite, equal to the
      capture frame, every ray hits at every depth, some shadow rays
      occluded, B5 and B6 launched once per cast and B0-B3 never; three
      frames timed, Mray/s printed beside the pairs headline of phase 4;
   c. on the kept depth-0 rays with no cap: B5's (t, idx) through
      ``intersect_tris_pallas`` must equal B0's through
      ``intersect_tris_pairs(payload=None)``, and the dense oracle
      (``intersect_tris_dense``, full f32) must agree on hit/miss, t within
      rtol 1e-5 and idx on >= 99.9% of hits;
   d. the production anchor (phase 6) and the realtime frame 1 (phase 7b,
      smooth normals: the fused smooth-normal recovery runs) rendered
      through the pallas traversal, each mean within 1% of the JAX
      package's CPU render;
   e. B5 and B6 timed against their plain versions on the depth-1 casts,
      with the (subgroup, tile) visits and Moller-Trumbore tests of each
      cast;
10. the big-mesh path: bench/big_mesh.py's 200,000-triangle soup through
    ``Renderer("array_bvh", obj_path=..., bvh_builder="lbvh")`` at
    512x512, spp 4, depth 2, whose pairs table (2,053 tiles, 262,784
    slots) is past the 32,768 slots where the JAX package streams its
    field table in supertiles (B4, run here by B0-B3 over the whole
    table):
   a. the host build: its seconds, the tables' sizes and the subgroup;
   b. one frame with the inputs of the depth-0 and depth-1 closest and
      shadow casts kept (524,288 rays each) and the peak device memory; on
      the busiest WINDOW_RAYS rays of each kept cast B1, B2 and B0 must
      equal their plain versions bit for bit, and so must B3 on a copy of
      the fields with seeded unit vertex normals (the soup has none); B0's
      and B3's (t, idx) must equal B1's;
   c. the frame again with the counters zeroed: finite, equal to the
      capture frame, every ray hits at every depth, B1 and B2 launched
      once per cast (BIG_CASTS each) and no other kernel; three frames
      timed, Mray/s printed;
   d. the same frame at ``pairs_subgroup=64`` (the soup's is 16) must
      equal it bit for bit; three frames timed, and B1 and B2 on the
      depth-1 casts of both subgroups, per Moller-Trumbore test;
   e. the same scene with ``traversal="pallas"`` (B5, B6): launches, the
      same hit and shadowed counts per depth, the image's largest
      difference from the pairs frame, three frames timed;
   f. the dense oracle on ORACLE_RAYS kept depth-0 rays, uncapped, against
      B1: t within rtol 1e-5 and idx equal on >= 99.9% of hits; hit/miss
      identical on >= 99.9% of the rays, and on every ray where it differs
      the deciding triangle lies within EDGE_MARGIN of its edge by the
      kernels' own arithmetic, which gives B1's answer (an edge graze that
      the oracle's matrix-product sums round the other way);
   g. B1 and B2 timed on the whole depth-1 casts against their bound, and
      on the casts' busiest windows (those of 10b) against their plain
      versions and the bound; the JSON line's ``pairs_b4`` entry holds the
      sums of both kernels' window numbers;
11. the probes (bench/micro_kernel.py, csrc/micro_kernel.cu: B7a tile
    slope, B7b mask in the kernel, B7c uniform branch, B7d row gather, B7e
    pair slope):
   a. at the entry point's defaults (PROBE_DEFAULT: 131,072 rays, 31
      tiles) and at the main path's cast size (PROBE_CAST: 524,288 rays,
      the cat's 40 tiles) every configuration of every probe (B7a at each
      L, B7b and its control, B7c under both masks, B7d, B7e at subgroups
      8, 16, 32, 64 and each L) must equal its plain version bit for bit;
   b. the entry point, ``bench.micro_kernel.main([])``, with the counters
      zeroed just before: every probe launched, no trace kernel; its
      timing tables (each case checked again inside), then the same
      tables at PROBE_CAST; the one PyTorch call that computes B7b
      (``torch.mul``) and B7d (``torch.index_select``) timed beside them;
12. the sweep and the last presets:
   a. ``bench.sweep.run_sweep`` on array_bvh 512x512, spps (8, 32) x
      bounces (3, 5), ``traversal="pairs"``, the counters zeroed just
      before: B1 and B2 launched once per cast of every frame, finite
      positive times, the (32, 5) cell's Mray/s beside the headline;
   b. one 512x512 spp 8 depth 5 frame of each of ``cpu``, ``global``,
      ``optimized`` and ``showcase``: finite, every ray hits at every
      depth (``cpu`` loses the few rays the JAX package loses there, see
      CPU_PRESET_HITS_FILE), B1 and B2 launched once per cast (no kernel for the
      mesh-less ``showcase``), Mray/s over two more frames; ``showcase``
      must send lanes through the mirror and refraction branches, and
      prints its total-internal-reflection lanes.

Each phase prints its wall time.  The next-to-last line is a JSON object
with one entry per kernel (its launches on the main path of its phase,
its largest error against the plain version, its time and the plain
version's on a depth-1 cast, and the bound: the larger of the cast's
Moller-Trumbore tests x FLOP_PER_TEST over PEAK_F32_FLOPS and the bytes
it must move over PEAK_BYTES_S; a probe's numbers are those of one
configuration at PROBE_DEFAULT, replayed from a CUDA graph, see
_PROBE_ROW); the last line is the JSON result.
Without a CUDA device the script exits nonzero at once and prints no
result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# Production anchor, 512x512 spp 8 depth 3 seed 0, array_bvh.  The JAX
# package's record (gallery/oracle_production_r05.jsonl, traversal "bvh")
# was rendered on a TPU, whose f32 rounding self-shadows more wall points
# (gallery/midres_platform_delta.json: array_bvh -3.5% against the CPU
# golden).  The check holds the port to the JAX package's CPU render of the
# same frame (render_rows in 32-row bands, traversal "pairs", mean of the
# f32 image in f64; PERF.md, "Production anchor", gives the command that
# prints it), and prints the TPU record beside it.
ANCHOR_TPU_MEAN = 102257.789
ANCHOR_CPU_MEAN = 104758.80389216123
ANCHOR_RTOL = 0.01
# Realtime anchor: frame 1 of the loop (realtime, 512x512, spp 20, depth 3,
# light at angle atan2(40, 0) + 0.02, key fold_in(PRNGKey(0), 0), the
# default quirk camera), the JAX package's CPU render in 32-row bands
# (PERF.md, "Realtime anchor", gives the command), same 1% limit.
ANCHOR_RT_CPU_MEAN = 74500.95069729118
LOOP_FRAMES = 6
# Phase 10: bench/big_mesh.py's soup; the JAX package streams a field
# table past ST_SLOTS slots in supertiles (B4); the plain versions are
# held on windows of WINDOW_RAYS rays of each cast (at the soup's 262,784
# slots they test every slot of 16 rays at a time), the dense oracle on
# ORACLE_RAYS
BIG_TRIS = 200_000
BIG_FRAME = dict(width=512, height=512, spp=4, max_depth=2)
BIG_CASTS = 4   # casts of each kernel in that frame: 2 depths x 2 chunks
ST_SLOTS = 32768
WINDOW_RAYS = 16384
ORACLE_RAYS = 8192
# a ray whose hit/miss differs between B1 and the dense oracle must graze
# an edge: the deciding barycentric within this of 0 (f32 rounding of
# O(1) sums in another order)
EDGE_MARGIN = 1e-5

# Phase 11: (rays, tiles) of the probe entry point's defaults and of the
# main path's casts (the cat's pairs tiles)
PROBE_DEFAULT = (131072, 31)
PROBE_CAST = (524288, 40)

# Phase 12: the `cpu` preset's scene is not quite closed to its own rays:
# in the frame phase 12b renders (512x512, spp 8, depth 5, seed 0) a few
# rays of 2,097,152 miss everything from depth 2 on.  The file records the
# lanes that lose them and the frame's hits at each depth; on the CPU
# tests/test_torch_presets.py renders every such lane through the JAX
# package and the port and requires the same losses.  The port must lose
# as many on the card, to HIT_RTOL of the rays.
CPU_PRESET_HITS_FILE = "tests/golden/cpu_512_lost_rays.json"
HIT_RTOL = 1e-5

# ptxas names the kernel templates' modes pairs_kernel<0..3>,
# pallas_kernel<false/true> and block_mask_kernel<false/true>
_MODES = {"pairs_kernelILi0E": "pairs_shadow",
          "pairs_kernelILi1E": "pairs_closest_idx",
          "pairs_kernelILi2E": "pairs_closest",
          "pairs_kernelILi3E": "pairs_closest_smooth",
          "pallas_kernelILb0E": "pallas_shadow",
          "pallas_kernelILb1E": "pallas_closest",
          "tile_slope_kernel": "probe_tile_slope",
          "block_mask_kernelILb1E": "probe_block_mask",
          "block_mask_kernelILb0E": "probe_block_mask (control)",
          "uniform_branch_kernel": "probe_uniform_branch",
          "row_gather_kernel": "probe_row_gather",
          "pair_slope_kernel": "probe_pair_slope"}
# (source, the TPU kernel it replaces) per kernel
_PAIRS = ("raytracinggpu_tpu_torch/csrc/pairs_trace.cu",
          "raytracinggpu_tpu/ops/pairs_trace.py:513")
_MICRO = "raytracinggpu_tpu_torch/csrc/micro_kernel.cu"
_ORIGIN = {
    "pairs_closest": _PAIRS, "pairs_shadow": _PAIRS,
    "pairs_closest_smooth": _PAIRS, "pairs_closest_idx": _PAIRS,
    "pallas_closest": ("raytracinggpu_tpu_torch/csrc/pallas_trace.cu",
                       "raytracinggpu_tpu/ops/pallas_trace.py:214"),
    "pallas_shadow": ("raytracinggpu_tpu_torch/csrc/pallas_trace.cu",
                      "raytracinggpu_tpu/ops/pallas_trace.py:310"),
    # B4, the JAX kernel's streamed-supertile grid: B1 and B2 past ST_SLOTS
    "pairs_b4": ("raytracinggpu_tpu_torch/csrc/pairs_trace.cu",
                 "raytracinggpu_tpu/ops/pairs_trace.py:784"),
    "probe_tile_slope": (_MICRO, "raytracinggpu_tpu/bench/micro_kernel.py:75"),
    "probe_block_mask": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:128"),
    "probe_uniform_branch": (_MICRO,
                             "raytracinggpu_tpu/bench/micro_kernel.py:189"),
    "probe_row_gather": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:233"),
    "probe_pair_slope": (_MICRO,
                         "raytracinggpu_tpu/bench/micro_kernel.py:312"),
}
# The configuration of each probe that the JSON line reports, at
# PROBE_DEFAULT: (key of bench.micro_kernel.main's result, its case)
_PROBE_ROW = {
    "probe_tile_slope": ("slope", dict(L=8)),
    "probe_block_mask": ("dma", None),
    "probe_uniform_branch": ("branch", dict(name="all_true")),
    "probe_row_gather": ("gather", None),
    "probe_pair_slope": ("pairslope", dict(subg=64, L=4)),
}
# The bound of a kernel (peak rates from NVIDIA's H100 SXM data
# sheet): f32 outside the tensor cores, and device memory.  One
# Moller-Trumbore test is 39 f32 operations: 21 multiplies, 17 adds and
# subtractions, one reciprocal (the 5 comparisons are not counted).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
FLOP_PER_TEST = 39
# The peak counts an FMA as two operations; the kernels are built without
# FMA (bitwise their plain versions), so each of a test's 39 operations
# issues alone: the floor of the pairs kernels is the tests' operations
# at half the peak
NO_FMA_OPS_S = PEAK_F32_FLOPS / 2


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


class _Laps:
    """Prints each phase's wall time as it ends: the time since the
    previous phase ended."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self, name: str) -> None:
        t = time.perf_counter()
        print(f"phase {name}: {t - self.t0:.2f} s", flush=True)
        self.t0 = t


def _card_line() -> str:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    try:
        return card_line()
    except RuntimeError as e:
        _fail(str(e))


def _time_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches (CUDA events), after one
    warm-up call."""
    from raytracinggpu_tpu_torch.bench._timing import timed

    return timed(fn, iters) * 1e3


def _max_abs_err(a, b) -> float:
    import torch

    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


def _mt_tests(kernel, args) -> tuple[int, int]:
    """(subgroup, tile) visits and Moller-Trumbore tests of one cast, from
    its culling input: a ray tests every slot of every tile its subgroup
    keeps (set bits of the pairs bitmask, the count of a tiled list)."""
    import torch

    subg = args[4]
    if kernel.startswith("pallas"):
        visits = int(args[2][:, 0].clamp_min(0).sum())
        tile_t = 128
    else:
        w = args[2].to(torch.int64) & 0xFFFFFFFF
        visits = int(sum(int(((w >> b) & 1).sum()) for b in range(32)))
        tile_t = args[5]
    return visits, visits * tile_t * subg


def _bound(kernel, args, outs) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the cast's operations over the
    f32 peak and the bytes it must move (the 9 ray-feature rows and the
    field rows read once, the culling input read once, the outputs written
    once) over the memory rate."""
    from raytracinggpu_tpu_torch.ops import _kernels

    rfT, fields, cull = args[:3]
    field_rows = _kernels._SPECS[kernel][1]
    nbytes = (9 * rfT.shape[1] + field_rows * fields.shape[1]) * 4 \
        + cull.numel() * 4 + sum(o.numel() * o.element_size() for o in outs)
    ops_s = _mt_tests(kernel, args)[1] * FLOP_PER_TEST / PEAK_F32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _capture_casts(render, per_kernel: int):
    """Run render() with each kernel's launch wrapper wrapped so that the
    inputs of its first ``per_kernel`` launches are kept.  The wrapped
    function is the real wrapper, which launches and counts as always; the
    originals are put back afterwards.  Returns ({kernel: [(rfT, culling
    input), ...]} in launch order, render's result)."""
    from raytracinggpu_tpu_torch.ops import _kernels

    kept = {k: [] for k in _kernels._SPECS}  # the trace kernels
    orig = {k: getattr(_kernels, k) for k in kept}

    def keeping(k):
        def launch(rfT, fields, bits, *rest):
            if len(kept[k]) < per_kernel:
                kept[k].append((rfT.clone(), bits.clone()))
            return orig[k](rfT, fields, bits, *rest)
        return launch

    for k in kept:
        setattr(_kernels, k, keeping(k))
    try:
        out = render()
    finally:
        for k, f in orig.items():
            setattr(_kernels, k, f)
    return kept, out


def _busiest_window(bits, subg: int, n: int) -> int:
    """First ray of the n-ray window of whole subgroups whose culling
    bitmask sets the most (subgroup, tile) bits."""
    import torch

    w = bits.to(torch.int64) & 0xFFFFFFFF
    per_sg = sum(((w >> b) & 1).sum(dim=0) for b in range(32))
    c = torch.cumsum(per_sg, 0)
    k = n // subg
    sums = c[k - 1:] - torch.cat([c.new_zeros(1), c[:-k]])
    return int(sums.argmax()) * subg


def _window(rfT, bits, subg: int, n: int):
    """(rfT, bits) of the busiest n-ray window of a cast (see
    _busiest_window), contiguous, and the window's first ray."""
    a = _busiest_window(bits, subg, n)
    return (rfT[:, a:a + n].contiguous(),
            bits[:, a // subg:(a + n) // subg].contiguous(), a)


def _check_casts(kept, plan, tab, cfg, err, label, fields=None, window=None):
    """Hold each kept cast's kernel bitwise against its plain version on
    the cast's inputs.  ``plan`` maps a captured kernel to the closest-hit
    kernels that run on its casts too (B0 on a closest cast), which must
    also equal their plain versions and give the captured kernel's (t,
    idx).  ``fields`` replaces the table's field rows; ``window`` holds
    the kernels on the busiest ``window`` rays of each cast instead of all
    of them.  Adds to ``err`` {kernel: max abs error}; returns the casts
    as [(name, depth, kernels, args)]."""
    import torch
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    casts = []
    for kname, extra in plan.items():
        if len(kept[kname]) != 2:
            _fail(f"{kname}: captured {len(kept[kname])} casts, expected 2")
        for depth, (rfT, bits) in enumerate(kept[kname]):
            name = f"{label} depth{depth} {kname}"
            if window:
                n_rays = rfT.shape[1]
                rfT, bits, a = _window(rfT, bits, cfg.pairs_subgroup, window)
                name += (f" rays [{a}, {a + window}) of {n_rays} (the "
                         "busiest window)")
            args = (rfT, tab.fields if fields is None else fields, bits,
                    cfg.eps_leaf, cfg.pairs_subgroup, pt.tile_width(tab))
            outs = {}
            for k in (kname, *extra):
                got = getattr(_kernels, k)(*args)
                want = getattr(pt, f"{k}_plain")(*args)
                if k == "pairs_shadow":
                    got, want = (got,), (want,)
                torch.cuda.synchronize()
                e = max(_max_abs_err(a, b) for a, b in zip(got, want))
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                if k == kname:
                    hits = int((want[0] < pt.INF32).sum())
                    pairs = int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                                    for w in bits.flatten().tolist()))
                    print(f"cast {name}: rfT {tuple(rfT.shape)}, bits "
                          f"{tuple(bits.shape)}, {hits} mesh hits, {pairs} "
                          f"(subgroup, tile) pairs")
                print(f"  {k} vs plain: "
                      f"{'bitwise equal' if same else f'DIFFER (max abs {e})'}")
                if not same:
                    _fail(f"{k} differs from its plain version on {name}")
                err[k] = max(err[k], e)
                outs[k] = got
            for k in extra:
                if not all(torch.equal(a, b) for a, b in
                           zip(outs[k][:2], outs[kname][:2])):
                    _fail(f"{k}'s (t, idx) differ from {kname}'s on {name}")
                print(f"  {k} (t, idx) == {kname} (t, idx)")
            casts.append((name, depth, (kname, *extra), args))
    return casts


def _time_casts(casts, timing, card, depths=(0, 1)):
    """Time every kernel of the casts at ``depths`` against its plain
    version; keeps the depth-1 times and bound in ``timing`` {kernel:
    (ms, plain_ms, bound_ms, bound_by)}."""
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    for name, depth, kernels, args in casts:
        if depth not in depths:
            continue
        for k in kernels:
            kern = getattr(_kernels, k)
            plain = getattr(pat if k.startswith("pallas") else pt,
                            f"{k}_plain")
            ms = _time_ms(lambda: kern(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), 3)
            out = kern(*args)
            bound_ms, bound_by = _bound(k, args,
                                        out if isinstance(out, tuple)
                                        else (out,))
            visits, tests = _mt_tests(k, args)
            floor_ms = tests * FLOP_PER_TEST / NO_FMA_OPS_S * 1e3
            if depth == 1:
                timing[k] = (ms, plain_ms, bound_ms, bound_by)
            print(f"timing {k} on the {name} cast ({args[0].shape[1]} "
                  f"rays, {visits} (subgroup, tile) visits, {tests} MT "
                  f"tests): kernel {ms:.4f} ms, {ms * 1e9 / tests:.3f} ps a "
                  f"test, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by}; roofline share {bound_ms / ms:.1%}), no-FMA "
                  f"floor {floor_ms:.4f} ms ({floor_ms / ms:.1%}) on {card}")


def _realtime(device, card, err, timing):
    """Phase 7 (module docstring).  Returns the loop's launch counts and,
    for phase 8, (config, scene tables, kept casts)."""
    import io
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey, fold_in
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.image_io import tonemap
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_rows)
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.checkpoint import load_state, save_state

    t0 = time.perf_counter()
    cfg, tables = build_preset("realtime", device)
    torch.cuda.synchronize()
    W, H, spp = cfg.width, cfg.height, cfg.spp
    g = group_size(cfg, spp)
    per_frame = (spp // g) * cfg.max_depth * -(-g * W * H
                                               // chunk_size(cfg, g * W * H))
    print(f"scene: realtime {W}x{H} spp {spp} depth {cfg.max_depth}, smooth "
          f"normals {cfg.smooth_normals}, {per_frame} closest casts a frame, "
          f"built in {time.perf_counter() - t0:.2f} s")
    if ((W, H, spp, cfg.max_depth, per_frame) != (512, 512, 20, 3, 30)
            or not cfg.smooth_normals):
        _fail("the realtime preset is not 512x512 spp 20 depth 3 with smooth "
              "normals and 30 closest casts a frame")
    want = lambda n: {**{k: 0 for k in _kernels.LAUNCHES},
                      "pairs_closest_smooth": n * per_frame,
                      "pairs_shadow": n * per_frame}

    # a. the first frame, casts kept
    state0 = rt.init_state(cfg, tables, seed=0)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    kept, (state1, disp1) = _capture_casts(
        lambda: rt.step(tables, cfg, state0), 2)
    torch.cuda.synchronize()
    first = dict(_kernels.LAUNCHES)
    print(f"realtime frame 1 (casts kept): {time.perf_counter() - t0:.3f} s, "
          f"launches {first}")
    if first != want(1):
        _fail(f"realtime frame 1 launches {first}, expected {want(1)}")
    casts = _check_casts(kept, {"pairs_closest_smooth": ("pairs_closest_idx",),
                                "pairs_shadow": ()},
                         tables.pairs_mesh, cfg, err, "realtime")

    # b. realtime anchor: frame 1 through render_rows
    angle0 = np.float32(np.arctan2(float(tables.L.z), float(tables.L.x)))
    angle1 = np.float32(angle0 + np.float32(0.02))
    if float(state1.light_angle) != float(angle1):
        _fail(f"frame 1 light angle {float(state1.light_angle)} != {angle1}")
    acc, stats = render_rows(rt.orbit_light(tables, angle1), cfg,
                             Camera.default(cfg, device),
                             fold_in(PRNGKey(0, device), 0),
                             np.arange(H, dtype=np.int32), range(spp))
    img = torch.stack([(c / float(spp)).reshape(H, W) for c in acc], dim=-1)
    hit = stats.hit.tolist()
    mean = float(img.double().mean())
    rel = (mean - ANCHOR_RT_CPU_MEAN) / ANCHOR_RT_CPU_MEAN
    print(f"realtime anchor: frame 1 mean {mean:.3f} vs the JAX package on "
          f"CPU {ANCHOR_RT_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL}); hit per depth {hit}, shadowed "
          f"{stats.shadowed.tolist()}")
    if not torch.equal(img, state1.accum):
        _fail("render_rows of frame 1 differs from the loop's frame 1")
    if any(h != W * H * spp for h in hit):
        _fail(f"rays escaped the realtime scene: hit {hit} != {W * H * spp}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("no shadow ray was occluded in the realtime frame")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"realtime anchor mean {mean} off by {rel:.4%}")

    # c. the loop
    # run_loop's own mean skips the first frame, whose time also holds the
    # enqueue of frame 2; the whole call's wall time over the frame count
    # is the rate the loop sustains, and is the one reported
    pipe = io.BytesIO()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    state, summary = rt.run_loop(tables, cfg, LOOP_FRAMES, seed=0,
                                 raw_pipe=pipe, print_every=0)
    torch.cuda.synchronize()
    frame_s = (time.perf_counter() - t0) / LOOP_FRAMES
    loop_launches = dict(_kernels.LAUNCHES)
    print(f"realtime loop: {LOOP_FRAMES} frames, {frame_s * 1e3:.3f} ms per "
          f"frame, {1 / frame_s:.3f} FPS, "
          f"{rays_per_frame(cfg) / frame_s / 1e6:.3f} Mray/s "
          f"({rays_per_frame(cfg)} rays a frame; run_loop's own mean "
          f"{summary['mean_ms']:.3f} ms, first frame "
          f"{summary['first_frame_ms']:.3f} ms), launches {loop_launches}, "
          f"on {card}")
    if loop_launches != want(LOOP_FRAMES):
        _fail(f"loop launches {loop_launches}, expected "
              f"{want(LOOP_FRAMES)}")
    angle = angle0
    for _ in range(LOOP_FRAMES):
        angle = np.float32(angle + np.float32(0.02))
    got = (int(state.frames), int(state.rng_frame), float(state.light_angle))
    if got != (LOOP_FRAMES, LOOP_FRAMES, float(angle)):
        _fail(f"loop state (frames, rng_frame, light angle) {got}, expected "
              f"{(LOOP_FRAMES, LOOP_FRAMES, float(angle))}")
    if not bool(torch.isfinite(state.accum).all()):
        _fail("realtime image has non-finite values")
    shown = np.frombuffer(pipe.getvalue(), np.uint8).reshape(
        LOOP_FRAMES, H, W, 3)
    if not np.array_equal(shown[0], disp1.cpu().numpy()):
        _fail("the loop's first display differs from frame 1's")
    avg = (state.accum / state.frames.to(torch.float32)).cpu().numpy()
    if not np.array_equal(shown[-1], tonemap(avg)):
        _fail("the last display is not the tonemap of the average")

    # d. checkpoint: save, load and step == the uninterrupted next frame
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        save_state(path, state)
        resumed = load_state(path, device)
    a, disp_a = rt.step(tables, cfg, resumed)
    b, disp_b = rt.step(tables, cfg, state)
    if not (torch.equal(a.accum, b.accum) and torch.equal(disp_a, disp_b)
            and int(a.frames) == LOOP_FRAMES + 1):
        _fail("a resumed checkpoint stepped to another frame")
    print(f"checkpoint: frame {LOOP_FRAMES + 1} after save/load is bitwise "
          "the uninterrupted one")

    # e. timings on the kept casts
    _time_casts(casts, timing, card)
    return loop_launches, (cfg, tables, casts)


def _mesh_query(cfg, tables, casts, err):
    """Phase 8 (module docstring): the public payload-less query on the
    primary rays of the realtime frame's first cast.  Returns its launch
    counts."""
    import torch
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    rfT = next(args[0] for _, depth, ks, args in casts
               if depth == 0 and ks[0] == "pairs_closest_smooth")
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rfT rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    tab = tables.pairs_mesh
    kw = dict(subg=cfg.pairs_subgroup, blk=cfg.pairs_block)
    _kernels.reset_launches()
    hit = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf, payload=None, **kw)
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected["pairs_closest_idx"] = 1
    print(f"mesh query: {O.x.shape[0]} primary rays, "
          f"{int((hit.t < pt.INF32).sum())} mesh hits, launches {launches}")
    if launches != expected:
        _fail(f"mesh query launches {launches}, expected {expected}")
    smooth, _ = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf,
                                        payload="smooth", **kw)
    rf, bits, R = pt.cast_inputs(O, u, tab, **kw)
    plain = pt.pairs_closest_idx_plain(rf, tab.fields, bits, cfg.eps_leaf,
                                       cfg.pairs_subgroup, pt.tile_width(tab))
    for a, b, what in ((hit.t, plain[0][:R], "plain t"),
                       (hit.idx, plain[1][:R], "plain idx"),
                       (hit.t, smooth.t, "B3's t"),
                       (hit.idx, smooth.idx, "B3's idx")):
        e = _max_abs_err(a, b)
        err["pairs_closest_idx"] = max(err["pairs_closest_idx"], e)
        if not torch.equal(a, b):
            _fail(f"mesh query: B0 differs from {what} (max abs {e})")
    print("mesh query: B0 bitwise equal to its plain version and to B3's "
          "(t, idx)")
    return launches


def _pallas(device, card, err, timing, pairs_mrays):
    """Phase 9 (module docstring).  Returns the headline frame's launch
    counts."""
    import dataclasses

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch.core.rng import PRNGKey, fold_in
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat
    from raytracinggpu_tpu_torch.ops.triangle import intersect_tris_dense
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame,
        render_rows)
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    # a. the capture frame
    t0 = time.perf_counter()
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5, traversal="pallas")
    torch.cuda.synchronize()
    tab = tables.pallas_mesh
    print(f"scene: array_bvh pallas, {tab.n_tiles} tiles of {pat.TILE_T} "
          f"triangles, subgroup {cfg.pallas_subgroup}, ray sort "
          f"{cfg.ray_sort}, built in {time.perf_counter() - t0:.2f} s")
    cam = Camera.default(cfg, device)
    g = group_size(cfg, cfg.spp)
    R_group = g * cfg.width * cfg.height
    chunk = chunk_size(cfg, R_group, "pallas")
    n_casts = (cfg.spp // g) * cfg.max_depth * -(-R_group // chunk)
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(
        lambda: render_frame(tables, cfg, cam, PRNGKey(0, device)), 2)
    torch.cuda.synchronize()
    print(f"pallas capture frame: {time.perf_counter() - t0:.3f} s; casts "
          f"of {chunk} rays")
    casts = []
    for k in ("pallas_closest", "pallas_shadow"):
        if len(kept[k]) != 2:
            _fail(f"{k}: captured {len(kept[k])} casts, expected 2")
        for depth, (rfT, lists) in enumerate(kept[k]):
            args = (rfT, tab.fields, lists, cfg.eps_leaf,
                    cfg.pallas_subgroup)
            got = getattr(_kernels, k)(*args)
            want = getattr(pat, f"{k}_plain")(*args)
            if k == "pallas_shadow":
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            e = max(_max_abs_err(a, b) for a, b in zip(got, want))
            err[k] = max(err[k], e)
            visits, tests = _mt_tests(k, args)
            print(f"cast pallas depth{depth} {k}: rfT {tuple(rfT.shape)}, "
                  f"lists {tuple(lists.shape)}, "
                  f"{int((want[0] < pat.INF32).sum())} mesh hits, {visits} "
                  f"(subgroup, tile) visits, {tests} MT tests; vs plain: "
                  f"{'bitwise equal' if e == 0.0 else f'DIFFER ({e})'}")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                _fail(f"{k} differs from its plain version at depth {depth}")
            casts.append((f"pallas depth{depth}", depth, (k,), args))

    # b. the headline frame through the pallas traversal
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = stats.hit.tolist()
    print(f"pallas headline frame: {time.perf_counter() - t0:.3f} s, "
          f"launches {launches} (expected {n_casts} each of B5, B6), hit "
          f"per depth {hit}, shadowed {stats.shadowed.tolist()}, image "
          f"mean {float(img.mean()):.3f}")
    if not bool(torch.isfinite(img).all()):
        _fail("pallas headline image has non-finite values")
    if not torch.equal(img, cap_img):
        _fail("pallas: the same seed gave another frame than the capture")
    if any(h != n_rays for h in hit):
        _fail(f"pallas: rays escaped the enclosed scene: hit {hit}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("pallas: no shadow ray was occluded")
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected.update(pallas_closest=n_casts, pallas_shadow=n_casts)
    if launches != expected:
        _fail(f"pallas launches in the frame {launches}, expected {expected}")
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(i + 1, device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = rays_per_frame(cfg) / min(times) / 1e6
    print(f"pallas headline: {mrays:.3f} Mray/s (array_bvh {cfg.width}x"
          f"{cfg.height} spp{cfg.spp} d{cfg.max_depth} pallas, frame times "
          f"{[round(t, 4) for t in times]} s) beside "
          f"the pairs headline {pairs_mrays:.3f} Mray/s of this call, on "
          f"{card}")

    # c. B5 against B0 and the dense oracle on the depth-0 rays, uncapped
    rfT = kept["pallas_closest"][0][0]
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    b5 = pat.intersect_tris_pallas(O, u, tab, cfg.eps_leaf, sort_rays=False,
                                   subg=cfg.pallas_subgroup)
    b0 = pt.intersect_tris_pairs(O, u, tables.pairs_mesh, cfg.eps_leaf,
                                 subg=cfg.pairs_subgroup,
                                 blk=cfg.pairs_block, payload=None)
    torch.cuda.synchronize()
    if not (torch.equal(b5.t, b0.t) and torch.equal(b5.idx, b0.idx)):
        n = int(((b5.t != b0.t) | (b5.idx != b0.idx)).sum())
        _fail(f"B5 and B0 differ on {n} uncapped depth-0 rays")
    dense = [intersect_tris_dense(
        Vec3(*(c[lo:lo + cfg.ray_chunk] for c in O)),
        Vec3(*(c[lo:lo + cfg.ray_chunk] for c in u)), tables.mesh,
        cfg.eps_leaf, cfg.tri_block) for lo in range(0, O.x.shape[0],
                                                     cfg.ray_chunk)]
    t_d = torch.cat([d.t for d in dense])
    i_d = torch.cat([d.idx for d in dense])
    hit5, hitd = b5.t < pat.INF32, t_d < pat.INF32
    both = hit5 & hitd
    rel = float(((b5.t - t_d).abs() / t_d.abs())[both].max()) \
        if bool(both.any()) else 0.0
    same_idx = float((b5.idx == i_d)[both].float().mean())
    print(f"B5 vs B0 on {O.x.shape[0]} uncapped depth-0 rays: (t, idx) "
          f"bitwise equal, {int(hit5.sum())} mesh hits; dense oracle: "
          f"hit/miss {'identical' if torch.equal(hit5, hitd) else 'DIFFER'}"
          f", t max rel diff {rel:.3g}, idx equal on {same_idx:.6f} of hits")
    if not torch.equal(hit5, hitd) or rel > 1e-5 or same_idx < 0.999:
        _fail("B5 disagrees with the dense oracle")

    # d. both anchors through the pallas traversal
    acfg = dataclasses.replace(cfg, spp=8, max_depth=3)
    aimg, _ = render_frame(tables, acfg, cam, PRNGKey(0, device))
    mean = float(aimg.double().mean())
    rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
    print(f"pallas anchor: 512x512 spp8 d3 seed 0 mean {mean:.3f} vs the JAX "
          f"package on CPU {ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL})")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"pallas anchor mean {mean} off by {rel:.4%}")
    rcfg, rtab = build_preset("realtime", device, traversal="pallas")
    angle1 = np.float32(np.float32(np.arctan2(float(rtab.L.z),
                                              float(rtab.L.x)))
                        + np.float32(0.02))
    W, H, spp = rcfg.width, rcfg.height, rcfg.spp
    acc, rstats = render_rows(rt.orbit_light(rtab, angle1), rcfg,
                              Camera.default(rcfg, device),
                              fold_in(PRNGKey(0, device), 0),
                              np.arange(H, dtype=np.int32), range(spp))
    rimg = torch.stack([(c / float(spp)).reshape(H, W) for c in acc], dim=-1)
    mean = float(rimg.double().mean())
    rel = (mean - ANCHOR_RT_CPU_MEAN) / ANCHOR_RT_CPU_MEAN
    print(f"pallas realtime anchor: frame 1 (smooth normals {rcfg.smooth_normals}) "
          f"mean {mean:.3f} vs the JAX package on CPU "
          f"{ANCHOR_RT_CPU_MEAN:.3f} (rel {rel:+.6f}, limit {ANCHOR_RTOL}); "
          f"hit per depth {rstats.hit.tolist()}")
    if not rcfg.smooth_normals:
        _fail("the realtime preset lost its smooth normals")
    if any(h != W * H * spp for h in rstats.hit.tolist()):
        _fail("pallas: rays escaped the realtime scene")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"pallas realtime anchor mean {mean} off by {rel:.4%}")

    # e. timings on the depth-1 casts
    _time_casts(casts, timing, card, depths=(1,))
    return launches


def _big_mesh(device, card, err):
    """Phase 10 (module docstring).  Returns (the soup frame's launch
    counts, the B4 entry's (ms, plain_ms, bound_ms, bound_by))."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch
    from raytracinggpu_tpu_torch import Renderer
    from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat
    from raytracinggpu_tpu_torch.ops.triangle import intersect_tris_dense
    from raytracinggpu_tpu_torch.render.pipeline import (
        chunk_size, group_size, rays_per_frame, render_preset_frame)

    # a. the host build through the public entry point
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "soup.obj")
        t0 = time.perf_counter()
        soup_obj(path, BIG_TRIS)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = Renderer("array_bvh", obj_path=path, bvh_builder="lbvh",
                     device=device, **BIG_FRAME)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    cfg, tables = r.cfg, r.scene
    tab = tables.pairs_mesh
    if tab is None:
        _fail("the soup fell back off the pairs tables")
    nc, Tc = tab.tile_aabb.shape[0], tab.fields.shape[1]
    print(f"soup: {BIG_TRIS} triangles written in {write_s:.2f} s, Renderer "
          f"(lbvh) built in {build_s:.2f} s: {nc} pairs tiles, "
          f"{tab.member_aabb.shape[0]} member boxes, fields "
          f"{tuple(tab.fields.shape)} ({tab.fields.numel() * 4} bytes), W = "
          f"{-(-nc // 32)} words, subgroup {cfg.pairs_subgroup}; "
          f"{tables.pallas_mesh.n_tiles} tiled-traversal tiles")
    if Tc <= ST_SLOTS:
        _fail(f"the soup's fields hold {Tc} slots, not past {ST_SLOTS}")
    W_, H_, spp = cfg.width, cfg.height, cfg.spp
    g = group_size(cfg, spp)
    R_group = g * W_ * H_
    n_casts = (spp // g) * cfg.max_depth * -(-R_group // chunk_size(cfg,
                                                                   R_group))
    if n_casts != BIG_CASTS:
        _fail(f"the soup frame makes {n_casts} casts a kernel, expected "
              f"{BIG_CASTS}")

    # b. per cast, on the busiest window of each kept cast; B3 on a copy of
    # the fields with seeded unit vertex normals (the soup has none)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(lambda: r.render_hdr(seed=0), 2)
    print(f"soup capture frame: {time.perf_counter() - t0:.3f} s, peak "
          f"device memory {torch.cuda.max_memory_allocated(device) / 2**30:.3f}"
          f" GiB")
    nrm = np.random.default_rng(0).standard_normal((3, Tc, 3))
    nrm /= np.linalg.norm(nrm, axis=2, keepdims=True)
    fields3 = tab.fields.clone()
    fields3[17:26] = torch.from_numpy(
        nrm.transpose(0, 2, 1).reshape(9, Tc).astype(np.float32)).to(device)
    if not torch.equal(fields3[:17], tab.fields[:17]):
        _fail("the normals copy changed the rows B0-B2 read")
    casts = _check_casts(
        kept, {"pairs_closest": ("pairs_closest_idx", "pairs_closest_smooth"),
               "pairs_shadow": ()},
        tab, cfg, err, "soup", fields=fields3, window=WINDOW_RAYS)
    print(f"soup: B0-B3 held on windows of {WINDOW_RAYS} rays of each kept "
          f"cast of {kept['pairs_closest'][0][0].shape[1]} rays")

    # c. the frame, counted
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = r.render_hdr(seed=0)
    counted_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_rays = W_ * H_ * spp
    print(f"soup frame: {counted_s:.3f} s, launches {launches}, hit per depth "
          f"{stats.hit.tolist()}, shadowed {stats.shadowed.tolist()}, image "
          f"mean {float(img.mean()):.3f}")
    if not np.isfinite(img).all():
        _fail("the soup frame has non-finite values")
    if not np.array_equal(img, cap_img):
        _fail("the soup: the same seed gave another frame than the capture")
    if any(h != n_rays for h in stats.hit.tolist()):
        _fail(f"the soup: rays escaped the enclosed scene: {stats.hit}")
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    if launches != expected:
        _fail(f"soup frame launches {launches}, expected {expected}")

    def timed_frames(render):
        times = []
        for i in range(3):
            t0 = time.perf_counter()
            render(i + 1)   # returns host numpy: synchronous
            times.append(time.perf_counter() - t0)
        return times

    times_auto = timed_frames(lambda seed: r.render_hdr(seed=seed))
    print(f"soup headline: {rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} "
          f"Mray/s ({rays_per_frame(cfg)} rays a frame, {min(times_auto):.4f} s "
          f"a frame, frame times {[round(t, 4) for t in times_auto]} s, "
          f"subgroup {cfg.pairs_subgroup}) on {card}")

    # d. subgroup 64: exact culling, so the same frame; its depth-1 casts
    cfg64 = dataclasses.replace(cfg, pairs_subgroup=64)
    kept64, (img64, stats64) = _capture_casts(
        lambda: render_preset_frame(tables, cfg64, seed=0), 2)
    if not (np.array_equal(img64, img) and all(
            np.array_equal(a, b) for a, b in zip(stats64, stats))):
        _fail(f"the soup frame at subgroup 64 differs from subgroup "
              f"{cfg.pairs_subgroup}'s")
    times64 = timed_frames(lambda seed: render_preset_frame(tables, cfg64,
                                                            seed=seed))
    print(f"soup frame at subgroup 64: bitwise the subgroup-"
          f"{cfg.pairs_subgroup} frame; "
          f"{rays_per_frame(cfg) / min(times64) / 1e6:.3f} Mray/s "
          f"({min(times64):.4f} s a frame) beside subgroup "
          f"{cfg.pairs_subgroup}'s "
          f"{rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} on {card}")
    for k in ("pairs_closest", "pairs_shadow"):
        for subg, cast in ((cfg.pairs_subgroup, kept[k][1]),
                           (64, kept64[k][1])):
            args = (cast[0], tab.fields, cast[1], cfg.eps_leaf, subg, 128)
            ms = _time_ms(lambda: getattr(_kernels, k)(*args), 10)
            visits, tests = _mt_tests(k, args)
            print(f"timing {k} on the soup depth-1 cast at subgroup {subg}: "
                  f"{ms:.4f} ms, {visits} (subgroup, tile) visits, {tests} "
                  f"MT tests, {ms * 1e9 / tests:.3f} ps a test, on {card}")

    # e. the tiled fallback on the same soup
    cfgp = dataclasses.replace(cfg, traversal="pallas")
    _kernels.reset_launches()
    imgp, statsp = render_preset_frame(tables, cfgp, seed=0)
    launches_p = dict(_kernels.LAUNCHES)
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected.update(pallas_closest=n_casts, pallas_shadow=n_casts)
    diff = float(np.abs(imgp.astype(np.float64) - img).max())
    print(f"soup pallas frame: launches {launches_p}, hit per depth "
          f"{statsp.hit.tolist()}, shadowed {statsp.shadowed.tolist()}; "
          f"largest difference from the pairs frame {diff} "
          f"({'bitwise equal' if np.array_equal(imgp, img) else 'not bitwise'})")
    if launches_p != expected:
        _fail(f"soup pallas launches {launches_p}, expected {expected}")
    if not (np.array_equal(statsp.hit, stats.hit)
            and np.array_equal(statsp.shadowed, stats.shadowed)):
        _fail("the soup's pallas frame hit or shadowed other rays")
    timesp = timed_frames(lambda seed: render_preset_frame(tables, cfgp,
                                                           seed=seed))
    print(f"soup pallas: {rays_per_frame(cfg) / min(timesp) / 1e6:.3f} Mray/s "
          f"({min(timesp):.4f} s a frame) beside pairs "
          f"{rays_per_frame(cfg) / min(times_auto) / 1e6:.3f} on {card}")

    # f. the dense oracle on kept depth-0 rays, uncapped
    rfT, _, a = _window(*kept["pairs_closest"][0], cfg.pairs_subgroup,
                        ORACLE_RAYS)
    u = Vec3(*(rfT[i].clone() for i in (0, 1, 2)))   # rows: u, O x u, O
    O = Vec3(*(rfT[i].clone() for i in (6, 7, 8)))
    b1, _ = pt.intersect_tris_pairs(O, u, tab, cfg.eps_leaf,
                                    subg=cfg.pairs_subgroup,
                                    blk=cfg.pairs_block, payload="geom")
    dense = intersect_tris_dense(O, u, tables.mesh, cfg.eps_leaf,
                                 cfg.tri_block)
    hit1, hitd = b1.t < pt.INF32, dense.t < pt.INF32
    both = hit1 & hitd
    rel = (float(((b1.t - dense.t).abs() / dense.t.abs())[both].max())
           if bool(both.any()) else 0.0)
    same_idx = float((b1.idx == dense.idx)[both].float().mean())
    # The oracle sums its Moller-Trumbore terms in a matrix product, the
    # kernels left to right, so a ray that grazes a triangle's edge can
    # hit by one and miss by the other; in a soup no neighbour takes the
    # hit.  A flip passes only where the kernels' own arithmetic, with no
    # culling, puts the deciding triangle within EDGE_MARGIN of its edge
    # and agrees with B1 (a hit B1 lost to the culling fails).
    flips = (hit1 != hitd).nonzero().flatten().tolist()
    margins = []
    for i in flips:
        tid = int((b1.idx if hit1[i] else dense.idx)[i])
        slot = int((tab.fields[16] == tid).nonzero()[0])
        rf = pt._ray_feature_rows(Vec3(*(c[i:i + 1] for c in O)),
                                  Vec3(*(c[i:i + 1] for c in u)))
        _, beta, gamma, ok = pat.mt_slots(rf, tab.fields[:, slot:slot + 1],
                                          cfg.eps_leaf, 0, 1)
        m = float(torch.minimum(torch.minimum(beta, gamma),
                                1.0 - beta - gamma))
        margins.append(m)
        if bool(ok) != bool(hit1[i]) or abs(m) > EDGE_MARGIN:
            _fail(f"soup oracle: ray {a + i} hit/miss differs (B1 "
                  f"{bool(hit1[i])}, kernel arithmetic {bool(ok)}) on "
                  f"triangle {tid}, {m} from its edge")
    print(f"soup oracle: {ORACLE_RAYS} depth-0 rays from ray {a}, uncapped: "
          f"{int(hit1.sum())} mesh hits; hit/miss identical on "
          f"{ORACLE_RAYS - len(flips)} rays, {len(flips)} edge grazes differ "
          f"(barycentric margins {margins}, limit {EDGE_MARGIN}); t max rel "
          f"diff {rel:.3g}, idx equal on {same_idx:.6f} of hits")
    if len(flips) > ORACLE_RAYS // 1000 or rel > 1e-5 or same_idx < 0.999:
        _fail("B1 disagrees with the dense oracle on the soup")

    # g. B1 and B2 on the depth-1 casts: the kernel and its bound on the
    # whole cast, as the frame runs it; the kernel, its plain version and
    # the bound on the busiest window that 10b held bitwise (a plain
    # version tests every slot of 16 rays at a time: tens of seconds for a
    # whole cast).  The B4 entry sums the window's numbers.
    total, bound_bys = [0.0, 0.0, 0.0], set()
    for k in ("pairs_closest", "pairs_shadow"):
        kern, plain = getattr(_kernels, k), getattr(pt, f"{k}_plain")
        rfT, bits = kept[k][1]
        whole = (rfT, tab.fields, bits, cfg.eps_leaf, cfg.pairs_subgroup, 128)
        window = next(a for _, d, ks, a in casts if d == 1 and ks[0] == k)
        for where, args in (("whole cast", whole), ("window", window)):
            ms = _time_ms(lambda: kern(*args), 10)
            out = kern(*args)
            bound_ms, bound_by = _bound(k, args, out if isinstance(out, tuple)
                                        else (out,))
            visits, tests = _mt_tests(k, args)
            line = (f"timing {k} on the soup depth-1 {where} "
                    f"({args[0].shape[1]} rays, {visits} (subgroup, tile) "
                    f"visits, {tests} MT tests): kernel {ms:.4f} ms")
            if where == "window":
                plain_ms = _time_ms(lambda: plain(*args), 1)
                for i, v in enumerate((ms, plain_ms, bound_ms)):
                    total[i] += v
                bound_bys.add(bound_by)
                line += f", plain {plain_ms:.4f} ms"
            print(f"{line}, bound {bound_ms:.4f} ms ({bound_by}; roofline "
                  f"share {bound_ms / ms:.1%}) on {card}")
    print(f"B4 (B1 + B2 on the busiest {WINDOW_RAYS}-ray windows of the "
          f"soup's depth-1 casts): {total[0]:.4f} ms, plain versions "
          f"{total[1]:.4f} ms, bound {total[2]:.4f} ms")
    return launches, (*total, "operations" if bound_bys == {"operations"}
                      else "bytes")


def _probe_bound(tests: int, nbytes: int) -> tuple[float, str]:
    """(bound_ms, bound_by) of a probe: its MT tests' operations over the
    f32 peak, or the bytes it must move over the memory rate, the larger."""
    ops_s = tests * FLOP_PER_TEST / PEAK_F32_FLOPS
    bytes_s = nbytes / PEAK_BYTES_S
    return max(ops_s, bytes_s) * 1e3, ("operations" if ops_s >= bytes_s
                                       else "bytes")


def _probes(device, card, err):
    """Phase 11 (module docstring).  Returns (the entry point's launch
    counts, {probe: (ms, plain_ms, bound_ms, bound_by)}, {probe: the ms of
    the one PyTorch call that computes it})."""
    import torch
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.ops import _kernels

    # a. every configuration bitwise, at both sizes
    for R, n_tiles in (PROBE_DEFAULT, PROBE_CAST):
        t0 = time.perf_counter()
        n = 0
        for c in mk.cases(R, n_tiles, device):
            name, label = c["kernel"], c["label"]
            got = c["run"](*c["args"])
            torch.cuda.synchronize()
            want = c["plain"](*c["args"])
            e = _max_abs_err(got, want)
            err[name] = max(err[name], e)
            if not (got.is_cuda and torch.equal(got, want)):
                _fail(f"{name} ({label}) differs from its plain version at "
                      f"{R} rays, {n_tiles} tiles (max abs {e})")
            if c["probe"] in ("slope", "pairslope") \
                    and bool((got < mk.MISS).any()) != (c["L"] > 0):
                _fail(f"{name} ({label}): hits with no visit, or none with "
                      "some")
            n += 1
        print(f"probes at {R} rays, {n_tiles} tiles: {n} configurations of "
              f"{len(_kernels.PROBES)} kernels bitwise equal to their plain "
              f"versions ({time.perf_counter() - t0:.2f} s)")

    # b. the entry point, counted, then its tables at the cast size
    R, n_tiles = PROBE_DEFAULT
    _kernels.reset_launches()
    res = mk.main([])
    torch.cuda.synchronize()
    launches = dict(_kernels.LAUNCHES)
    print(f"probe entry point: launches {launches} on {card}")
    for k, n in launches.items():
        if (n > 0) != (k in _kernels.PROBES):
            _fail(f"the probe entry point launched {k} {n} times")
    iters = 30
    print(f"the same tables at {PROBE_CAST[0]} rays, {PROBE_CAST[1]} tiles, "
          f"on {card}:")
    mk.bench_pair_slope(*PROBE_CAST, iters, device)
    mk.bench_tile_slope(*PROBE_CAST, iters, device)
    mk.bench_dma_smem(PROBE_CAST[0], iters, device)
    mk.bench_scalar_branch(*PROBE_CAST, iters, device)
    mk.bench_inkernel_gather(PROBE_CAST[0], iters, device)

    timing, rows = {}, {}
    for name, (key, want) in _PROBE_ROW.items():
        case = rows[name] = res[key] if want is None else next(
            c for c in res[key] if all(c[k] == v for k, v in want.items()))
        bound_ms, bound_by = _probe_bound(case["tests"], case["nbytes"])
        timing[name] = (case["s"] * 1e3, case["plain_s"] * 1e3, bound_ms,
                        bound_by)
        print(f"timing {name} ({want or ''}; {R} rays, {n_tiles} tiles, "
              f"{case['tests']} MT tests, {case['nbytes']} bytes): "
              f"kernel {timing[name][0]:.4f} ms, plain {timing[name][1]:.4f} "
              f"ms, bound {bound_ms:.4f} ms ({bound_by}; roofline share "
              f"{bound_ms / timing[name][0]:.1%}) on {card}")
    # the one PyTorch call that computes B7b (2 x) and B7d (a row gather),
    # on the inputs the entry point used, replayed from a graph as the
    # kernels are
    x = rows["probe_block_mask"]["args"][0]
    idx, table = rows["probe_row_gather"]["args"]
    idx = idx[:, 0]
    library = {}
    for name, what, call in (
            ("probe_block_mask", "torch.mul", lambda: torch.mul(x, 2.0)),
            ("probe_row_gather", "torch.index_select",
             lambda: torch.index_select(table, 0, idx))):
        if not torch.equal(call(), rows[name]["out"]):
            _fail(f"{what} differs from the {name} kernel")
        library[name] = timed(call, 300, graph=True) * 1e3
        print(f"timing {what} on {name}'s inputs: {library[name]:.4f} ms "
              f"beside the kernel's {timing[name][0]:.4f} ms, on {card}")
    return launches, timing, library


def _sweep_and_presets(device, card, headline_mrays):
    """Phase 12 (module docstring)."""
    import torch
    from raytracinggpu_tpu_torch.bench.sweep import run_sweep
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame)
    from raytracinggpu_tpu_torch.scene.presets import (
        build_preset, make_config)

    def casts(cfg):
        g = group_size(cfg, cfg.spp)
        R_group = g * cfg.width * cfg.height
        return (cfg.spp // g) * cfg.max_depth * -(-R_group
                                                  // chunk_size(cfg, R_group))

    # a. the sweep through the public function
    spps, bounces, repeats = (8, 32), (3, 5), 3
    _kernels.reset_launches()
    res = run_sweep(preset="array_bvh", width=512, height=512, spps=spps,
                    bounces=bounces, repeats=repeats, traversal="pairs",
                    device=device)
    launches = dict(_kernels.LAUNCHES)
    frames = 1 + max(1, repeats - 1)
    n_casts = frames * sum(
        casts(make_config("array_bvh", width=512, height=512, spp=s,
                          max_depth=b)) for s in spps for b in bounces)
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    print(f"sweep: launches {launches} (expected {n_casts} each of B1, B2)")
    if launches != expected:
        _fail(f"sweep launches {launches}, expected {expected}")
    if sorted(res) != sorted((s, b) for s in spps for b in bounces):
        _fail(f"sweep cells {sorted(res)}")
    for cell, r in res.items():
        if not all(math.isfinite(r[k]) and r[k] > 0
                   for k in ("first_s", "steady_s", "mrays")):
            _fail(f"sweep cell {cell}: {r}")
    print(f"sweep cell spp 32 x depth 5: {res[(32, 5)]['mrays']:.3f} Mray/s "
          f"(the mean of {frames - 1} frames) beside the headline "
          f"{headline_mrays:.3f} Mray/s (the best of 3) of this call, on "
          f"{card}")

    # b. one frame of each of the other presets
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           CPU_PRESET_HITS_FILE)) as f:
        cpu_hits = tuple(json.load(f)["hits_per_depth"])
    for preset in ("cpu", "global", "optimized", "showcase"):
        t0 = time.perf_counter()
        cfg, tables = build_preset(preset, device, width=512, height=512,
                                   spp=8, max_depth=5)
        cam = Camera.default(cfg, device)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        _kernels.reset_launches()
        img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
        torch.cuda.synchronize()
        launches = dict(_kernels.LAUNCHES)
        n = 0 if tables.mesh is None else casts(cfg)
        expected = {k: 0 for k in _kernels.LAUNCHES}
        expected.update(pairs_closest=n, pairs_shadow=n)
        n_rays = cfg.width * cfg.height * cfg.spp
        if not bool(torch.isfinite(img).all()):
            _fail(f"{preset}: the frame has non-finite values")
        hit = stats.hit.tolist()
        want_hit = cpu_hits if preset == "cpu" else (n_rays,) * 5
        slack = HIT_RTOL * n_rays if preset == "cpu" else 0
        if any(abs(h - w) > slack for h, w in zip(hit, want_hit)) \
                or hit[:2] != [n_rays] * 2:
            _fail(f"{preset}: hits per depth {hit}, expected {want_hit}")
        if launches != expected:
            _fail(f"{preset}: launches {launches}, expected {expected}")
        times = []
        for i in (1, 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render_frame(tables, cfg, cam, PRNGKey(i, device))
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        same = (" (the JAX package on CPU: the same)"
                if preset == "cpu" and tuple(hit) == cpu_hits else "")
        print(f"preset {preset}: built in {build_s:.2f} s, {cfg.width}x"
              f"{cfg.height} spp{cfg.spp} d{cfg.max_depth} frame mean "
              f"{float(img.mean()):.3f}, hits per depth {hit} of {n_rays}"
              f"{same}, "
              f"{n} launches each of B1, B2, shadowed "
              f"{stats.shadowed.tolist()}; "
              f"{rays_per_frame(cfg) / min(times) / 1e6:.3f} Mray/s (frame "
              f"times {[round(t, 4) for t in times]} s) on {card}")
        if preset == "showcase":
            mirror, refract, tir = (int(x.sum()) for x in (
                stats.mirror, stats.refract, stats.tir))
            print(f"preset showcase: lanes per depth through the mirror "
                  f"branch {stats.mirror.tolist()}, refraction "
                  f"{stats.refract.tolist()}, total internal reflection "
                  f"{stats.tir.tolist()}")
            if mirror <= 0 or refract <= 0:
                _fail(f"showcase: mirror {mirror}, refraction {refract} "
                      "lanes")
        elif int(stats.shadowed.sum()) <= 0:
            _fail(f"{preset}: no shadow ray was occluded")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    lap = _Laps()

    # ---- 1. environment --------------------------------------------------
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")
    lap("1 environment")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    info = _kernels.BUILD_INFO
    build_s = time.perf_counter() - t0
    print(f"nvcc: {info['nvcc']} ({info['nvcc_version']})")
    print(f"build: {'compiled' if info['compiled'] else 'cached'} "
          f"{os.path.relpath(info['library'])} in {info['seconds']:.2f} s "
          f"(build+load {build_s:.2f} s)")
    entry = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            # the template argument tells the specializations apart
            entry = next((k for m, k in _MODES.items() if m in line), "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {entry}: {line.strip()}")
    lap("2 build")

    # ---- 3. per-cast check -----------------------------------------------
    t0 = time.perf_counter()
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5)
    torch.cuda.synchronize()
    print(f"scene: array_bvh {cfg.width}x{cfg.height} spp {cfg.spp} depth "
          f"{cfg.max_depth}, {tables.pairs_mesh.tile_aabb.shape[0]} tiles, "
          f"subgroup {cfg.pairs_subgroup}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    tab = tables.pairs_mesh
    cam = Camera.default(cfg, device)
    g = group_size(cfg, cfg.spp)
    R_group = g * cfg.width * cfg.height
    chunk = chunk_size(cfg, R_group)
    n_casts = (cfg.spp // g) * cfg.max_depth * -(-R_group // chunk)
    # The integrator launches each kernel once per depth, so the first two
    # launches of each are the depth-0 and depth-1 casts of the frame's
    # first wavefront (samples 0..g-1) and its first chunk of `chunk` rays.
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(
        lambda: render_frame(tables, cfg, cam, PRNGKey(0, device)), 2)
    torch.cuda.synchronize()
    print(f"capture frame: {time.perf_counter() - t0:.3f} s; casts of "
          f"{chunk} rays ({g} samples per wavefront)")
    err = {k: 0.0 for k in _kernels.LAUNCHES}
    casts = _check_casts(kept, {"pairs_closest": ("pairs_closest_idx",),
                                "pairs_shadow": ()},
                         tab, cfg, err, "array_bvh")
    lap("3 per-cast check")

    # ---- 4. headline frame -----------------------------------------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = stats.hit.tolist()
    print(f"headline frame: {counted_s:.3f} s, launches {launches} "
          f"(expected {n_casts} each), hit per depth {hit}, shadowed "
          f"{stats.shadowed.tolist()}, image mean {float(img.mean()):.3f}")
    if not bool(torch.isfinite(img).all()):
        _fail("headline image has non-finite values")
    if not torch.equal(img, cap_img):
        _fail("the same seed gave another frame than the capture frame")
    if any(h != n_rays for h in hit):
        _fail(f"rays escaped the enclosed scene: hit {hit} != {n_rays}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("no shadow ray was occluded")
    expected = {k: 0 for k in _kernels.LAUNCHES}
    expected.update(pairs_closest=n_casts, pairs_shadow=n_casts)
    if launches != expected:
        _fail(f"launches in the frame {launches}, expected {expected}")
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(i + 1, device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = rays_per_frame(cfg) / min(times) / 1e6
    print(f"headline: {mrays:.3f} Mray/s (array_bvh 512x512 spp32 d5 pairs, "
          f"{rays_per_frame(cfg)} rays/frame, frame times "
          f"{[round(t, 4) for t in times]} s) on {card}")
    lap("4 headline frame")

    # ---- 5. kernel timings -----------------------------------------------
    # every captured cast is timed; the JSON line reports the depth-1 ones
    # (B1 and B2 here, B3 and B0 on the realtime casts of phase 7)
    timing_main = {}
    _time_casts(casts, timing_main, card)
    lap("5 kernel timings")

    # ---- 6. production anchor --------------------------------------------
    import dataclasses

    acfg = dataclasses.replace(cfg, spp=8, max_depth=3)
    img, _ = render_frame(tables, acfg, cam, PRNGKey(0, device))
    mean = float(img.double().mean())
    rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
    print(f"anchor: 512x512 spp8 d3 seed 0 image mean {mean:.3f} vs the JAX "
          f"package on CPU {ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL}); its TPU record {ANCHOR_TPU_MEAN} (rel "
          f"{(mean - ANCHOR_TPU_MEAN) / ANCHOR_TPU_MEAN:+.5f})")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"anchor mean {mean} off by {rel:.4%}")
    lap("6 production anchor")

    # ---- 7. realtime loop ------------------------------------------------
    timing_rt = {}
    loop_launches, (rcfg, rtab, rcasts) = _realtime(device, card, err,
                                                    timing_rt)
    lap("7 realtime loop")

    # ---- 8. mesh query ---------------------------------------------------
    query_launches = _mesh_query(rcfg, rtab, rcasts, err)
    lap("8 mesh query")

    # ---- 9. the tiled-kernel traversal -----------------------------------
    timing_pallas = {}
    pallas_launches = _pallas(device, card, err, timing_pallas, mrays)
    lap("9 tiled traversal")

    # ---- 10. the big-mesh path -------------------------------------------
    err_b4 = {k: 0.0 for k in _kernels.LAUNCHES}
    soup_launches, b4 = _big_mesh(device, card, err_b4)
    lap("10 big-mesh path")
    # B4 is B1 and B2 past ST_SLOTS: its launches are theirs in the soup
    # frame, its error the largest of B0-B3's there, its times the sums of
    # B1's and B2's on the busiest windows of the depth-1 casts
    err["pairs_b4"] = max(err_b4.values())
    timing_b4 = {"pairs_b4": b4}
    soup_launches["pairs_b4"] = (soup_launches["pairs_closest"]
                                 + soup_launches["pairs_shadow"])

    # ---- 11. the probes --------------------------------------------------
    probe_launches, timing_probes, library = _probes(device, card, err)
    lap("11 probes")

    # ---- 12. the sweep and the last presets ------------------------------
    _sweep_and_presets(device, card, mrays)
    lap("12 sweep and presets")

    # no single PyTorch call computes a masked Moller-Trumbore closest hit
    # or nearest t, so library_ms is null for every kernel but B7b (2 x:
    # torch.mul) and the row gather (torch.index_select)
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": _ORIGIN[k][0],
         "replaces": _ORIGIN[k][1], "launches": counts[k],
         "max_abs_err": err[k], "ms": timing[k][0], "plain_ms": timing[k][1],
         "bound_ms": timing[k][2], "bound_by": timing[k][3],
         "library_ms": library.get(k)}
        for k, counts, timing in (
            ("pairs_closest", launches, timing_main),
            ("pairs_shadow", launches, timing_main),
            ("pairs_closest_smooth", loop_launches, timing_rt),
            ("pairs_closest_idx", query_launches, timing_rt),
            ("pallas_closest", pallas_launches, timing_pallas),
            ("pallas_shadow", pallas_launches, timing_pallas),
            ("pairs_b4", soup_launches, timing_b4),
            *((k, probe_launches, timing_probes) for k in _PROBE_ROW))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
