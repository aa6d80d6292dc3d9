"""The measured-results gallery of the port (port of
``raytracinggpu_tpu/bench/gallery.py``).

Writes, under ``--out`` (default ``gallery_torch/``):

- ``torch_results.json``: the frame rows (mean time of a warm frame and
  Mray/s of every preset at its full size, and ``array_bvh`` at 800x600),
  the realtime rows (the ``realtime`` preset's work through batched
  ``render/realtime.steps``: full spp 20 depth 3, and progressive
  accumulation at lower spp and depth) and the interactive rows (the
  pipelined ``run_loop``);
- ``torch_ablations.json``: the named modes of ``ABLATION_MODES`` on the
  ``array_bvh`` frame, each a set of ``RenderConfig`` overrides.

Never ``gallery/*.json``: those are the TPU's records.  Each file carries
the device, the card's name and power limit (``_timing.card_line``) and
the torch and CUDA versions; each run writes the files of the sections it
ran.  A row whose measurement raised records ``{"error": ...}``, and then
``main`` exits 1.

The JAX package's modes that name a knob the port does not have (ROADMAP,
"Not to port") are in ``DROPPED`` with the reason, and ``main`` prints
them; modes whose names state a mechanism the port lacks are renamed
(``RENAMED``).

    python -m raytracinggpu_tpu_torch.bench.gallery [--quick]
        [--only frames,realtime,interactive,ablations] [--rows NAMES]
        [--ablation-rows NAMES] [--ablation-row NAME] [--out DIR]
        [--device cpu]
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
import traceback
from dataclasses import replace

import torch

from raytracinggpu_tpu_torch.bench._timing import card_line, timed
from raytracinggpu_tpu_torch.core.device import render_device
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    rays_per_frame,
    render_frame,
)
from raytracinggpu_tpu_torch.render.realtime import init_state, run_loop, steps
from raytracinggpu_tpu_torch.scene.presets import build_preset

FRAME_CASES = (  # (row, preset, width, height)
    *((p, p, 512, 512)
      for p in ("cpu", "global", "optimized", "array_bvh", "showcase")),
    ("array_bvh_800x600", "array_bvh", 800, 600),
)
REALTIME_CASES = (  # (row, width, height, spp, depth)
    ("realtime_512x512", 512, 512, 20, 3),
    ("realtime_800x600", 800, 600, 20, 3),
    ("progressive_512x512_spp4", 512, 512, 4, 3),
    ("progressive_800x600_spp2", 800, 600, 2, 3),
    ("progressive_800x600_spp1_d2", 800, 600, 1, 2),
    ("progressive_800x600_spp2_d2", 800, 600, 2, 2),
    ("progressive_800x600_spp1_d3", 800, 600, 1, 3),
    ("progressive_800x600_spp1_d1", 800, 600, 1, 1),
    ("realtime_batched_512_spp2_d2", 512, 512, 2, 2),
)
INTERACTIVE_CASES = (
    ("realtime_interactive_512", 512, 512, 2, 2),
    ("realtime_interactive_800x600", 800, 600, 2, 2),
    ("realtime_interactive_800x600_spp1_d2", 800, 600, 1, 2),
)
PROTOCOL = (512, 512, 32, 5)  # the ablation rows' size; --quick: spp 8

_BVH_NOTE = ("the bvh walk is torch ops (no kernel); the row keeps the JAX "
             "package's reduced 128^2 spp2 d2 size")

# Named modes: RenderConfig overrides; "_size" (w, h, spp, depth) replaces
# the protocol size and "_note" annotates the row.
ABLATION_MODES = {
    "pairs_default(ladder_f078_f133_s64_u8_mind1_c512k)": {},
    "pairs_compact_all_depths": {"pairs_compact_min_depth": 0},
    "pairs_compact_mind2": {"pairs_compact_min_depth": 2},
    "pairs_nocompact_s16": {"pairs_compact": 0.0, "pairs_compact2": 0.0,
                            "pairs_subgroup": 16},
    "pairs_nocompact_s64": {"pairs_compact": 0.0, "pairs_compact2": 0.0},
    "pairs_single_f0625": {"pairs_compact": 0.0625, "pairs_compact2": 0.0},
    "pairs_single_f09375": {"pairs_compact": 0.09375, "pairs_compact2": 0.0},
    "pairs_single_f125": {"pairs_compact": 0.125, "pairs_compact2": 0.0},
    "pairs_single_f15625": {"pairs_compact": 0.15625, "pairs_compact2": 0.0},
    "pairs_ladder_wide_f125_f25": {"pairs_compact": 0.125,
                                   "pairs_compact2": 0.25},
    "pairs_compact_s16": {"pairs_subgroup": 16},
    "pairs_compact_s32": {"pairs_subgroup": 32},
    "pairs_compact_s128": {"pairs_subgroup": 128},
    "pairs_sah_pave_compact": {"pairs_cluster": "sah", "pairs_pack": "pave",
                               "pairs_cut": 32},
    "pairs_sah_pave_nocompact_s16": {
        "pairs_cluster": "sah", "pairs_pack": "pave", "pairs_cut": 32,
        "pairs_compact": 0.0, "pairs_subgroup": 16},
    "pairs_blk1024": {"pairs_block": 1024},
    "pairs_blk8192": {"pairs_block": 8192},
    "pairs_chunk262k": {"pairs_chunk": 262144},
    "pairs_chunk1M": {"pairs_chunk": 1048576},
    "pairs_chunk64k": {"pairs_chunk": 65536},
    "pallas_tiled_s64": {"traversal": "pallas"},
    "pallas_s32": {"traversal": "pallas", "pallas_subgroup": 32},
    "pallas_raysort": {"traversal": "pallas", "ray_sort": True},
    "dense": {"traversal": "dense"},
    "bvh_skiplinks": {"traversal": "bvh", "_size": (128, 128, 2, 2),
                      "_note": _BVH_NOTE},
    "bvh_aos10": {"traversal": "bvh", "bvh_node_layout": "aos10",
                  "_size": (128, 128, 2, 2),
                  "_note": "node-layout ablation: the reference's 10-float "
                           "record, one row gather a step; " + _BVH_NOTE},
    "spp_fuse1": {"spp_fuse": 1},
    "spp_fuse8": {"spp_fuse": 8},
    "pairs_tile256": {"pairs_tile": 256},
    "pairs_tile512": {"pairs_tile": 512},
}

# The JAX package's mode names whose names state a mechanism the port
# lacks (the MXU), and the port's names for them
RENAMED = {"dense_mxu_highest": "dense"}

DROPPED = {
    "depth_scan_rolled": "depth_unroll: an XLA scan back-edge; the port's "
                         "depth loop is Python ('Not to port')",
    "dense_mxu_bf16x3": "mxu_precision: a TPU matrix-unit precision "
                        "('Not to port')",
    "pairs_wordmajor": "pairs_sgw: the TPU kernel's walk order ('Not to "
                       "port')",
}

# Overrides that change the built scene tables (build_preset forwards them
# to build_scene_tables): a mode touching one rebuilds the preset
_TABLE_KEYS = ("tri_block", "pairs_tile", "pairs_cluster", "pairs_cut",
               "pairs_pack")


def _select(cases, rows):
    return [c for c in cases if rows is None or c[0] in rows]


def frame_rows(device, quick=False, rows=None) -> dict:
    """Each preset's frame at its full spp and depth (--quick: spp 4): the
    mean of 3 warm frames (``_timing.timed``: between CUDA events on the
    card, the host clock on the CPU)."""
    return {name: _row(name, lambda p=preset, w=w, h=h: _frame(
        device, quick, p, w, h))
        for name, preset, w, h in _select(FRAME_CASES, rows)}


def _frame(device, quick, preset, w, h) -> dict:
    cfg, tables = build_preset(preset, device, width=w, height=h)
    if quick:
        cfg = replace(cfg, spp=4)
    cam = Camera.default(cfg, device)
    seeds = itertools.count()
    dt = timed(lambda: render_frame(tables, cfg, cam,
                                    PRNGKey(next(seeds), device)),
               iters=3, warm=1, device=device)
    return {"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
            "depth": cfg.max_depth, "traversal": cfg.traversal,
            "frame_s": dt, "mrays": rays_per_frame(cfg) / dt / 1e6,
            "note": "mean of 3 warm frames"}


def realtime_rows(device, quick=False, rows=None) -> dict:
    """The realtime preset's work (spp 20, depth 3, realtime_render.cu
    :1264-1265) through batched ``steps``, and progressive accumulation at
    lower spp and depth."""
    n = 4 if quick else 10
    out = {}
    for name, w, h, spp, depth in _select(REALTIME_CASES, rows):
        def run(w=w, h=h, spp=spp, depth=depth):
            cfg, tables = build_preset("realtime", device, width=w, height=h,
                                       spp=spp, max_depth=depth)
            state = init_state(cfg, tables, seed=0)
            dt = timed(lambda: steps(tables, cfg, n, state), iters=1,
                       warm=1, device=device) / n
            return {"width": w, "height": h, "spp": spp, "depth": depth,
                    "frames": n, "ms_per_frame": dt * 1e3, "fps": 1.0 / dt,
                    "note": "batched steps(), "
                    + ("progressive accumulation" if spp < 20
                       else "the full realtime work a frame")}
        out[name] = _row(name, run)
    return out


def interactive_rows(device, quick=False, rows=None) -> dict:
    """The pipelined host loop (``run_loop``: frame n+1 enqueued before
    frame n is read back), timed by the wall clock over its frames."""
    n = 6 if quick else 20
    out = {}
    for name, w, h, spp, depth in _select(INTERACTIVE_CASES, rows):
        def run(w=w, h=h, spp=spp, depth=depth):
            cfg, tables = build_preset("realtime", device, width=w, height=h,
                                       spp=spp, max_depth=depth)
            run_loop(tables, cfg, 2, print_every=0)  # warm
            t0 = time.perf_counter()
            _, summary = run_loop(tables, cfg, n, print_every=0)
            dt = (time.perf_counter() - t0) / n
            return {"width": w, "height": h, "spp": spp, "depth": depth,
                    "frames": n, "ms_per_frame": dt * 1e3, "fps": 1.0 / dt,
                    "run_loop_mean_ms": summary["mean_ms"],
                    "note": "wall time over the frames of a pipelined "
                            "run_loop, PNG writes excluded; run_loop's own "
                            "mean_ms times the same frames inside the loop, "
                            "from one display's arrival to the next"}
        out[name] = _row(name, run)
    return out


def one_ablation_row(name: str, device, quick=False,
                     cache: dict | None = None) -> dict:
    """Measure one named mode in this process.  ``cache`` keeps the
    array_bvh tables of each size and table overrides for the modes that
    share them."""
    over = dict(ABLATION_MODES[name])
    note = over.pop("_note", None)
    w, h, spp, depth = over.pop("_size", PROTOCOL[:2] + (
        8 if quick else PROTOCOL[2], PROTOCOL[3]))
    table_over = {k: over[k] for k in _TABLE_KEYS if k in over}
    cache = {} if cache is None else cache
    key = (w, h, spp, depth, tuple(sorted(table_over.items())))
    if key not in cache:
        cache[key] = build_preset("array_bvh", device, width=w, height=h,
                                  spp=spp, max_depth=depth, **table_over)
    cfg0, tables = cache[key]
    cfg = replace(cfg0, **over)
    cam = Camera.default(cfg, device)
    seeds = itertools.count()
    dt = timed(lambda: render_frame(tables, cfg, cam,
                                    PRNGKey(next(seeds), device)),
               iters=2, warm=1, device=device)
    row = {"width": w, "height": h, "spp": spp, "depth": depth,
           "overrides": over, "frame_s": dt,
           "mrays": rays_per_frame(cfg) / dt / 1e6}
    if note:
        row["note"] = note
    return row


def ablation_rows(device, quick=False, names=None) -> dict:
    cache: dict = {}
    return {name: _row(name, lambda name=name: one_ablation_row(
        name, device, quick, cache)) for name in (names or ABLATION_MODES)}


def _row(name: str, measure) -> dict:
    """One row: what ``measure()`` returns, or the error it raised (its
    traceback to stderr)."""
    try:
        row = measure()
    except Exception as e:  # a row's failure is recorded; main exits 1
        traceback.print_exc()
        row = {"error": f"{type(e).__name__}: {e}"[:300]}
    print(name, json.dumps(row), flush=True)
    return row


def _header(device) -> dict:
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    return {"device": str(dev),
            "card": card_line() if on_card else None,
            "device_name": (torch.cuda.get_device_name(dev) if on_card
                            else "cpu"),
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _write(path: str, header: dict, rows: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({**header, "rows": rows}, f, indent=1)
    print("wrote", path, flush=True)


def _names(arg: str | None):
    return None if arg is None else [s for s in arg.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="gallery_torch")
    ap.add_argument("--quick", action="store_true",
                    help="spp 4 frames, spp 8 ablations, shorter loops")
    ap.add_argument("--only", default=None,
                    help="comma list of frames,realtime,interactive,ablations")
    ap.add_argument("--rows", default=None,
                    help="comma list: measure only these rows of the frames, "
                         "realtime and interactive sections")
    ap.add_argument("--ablation-rows", default=None,
                    help="comma list: the ablation section measures only "
                         "these modes")
    ap.add_argument("--ablation-row", default=None,
                    help="measure one named mode, print one JSON line and "
                         "write no file")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the first CUDA card)")
    a = ap.parse_args(argv)
    device = render_device(a.device)

    print("dropped JAX modes:", flush=True)
    for name, why in DROPPED.items():
        print(f"  {name}: {why}")
    print("renamed JAX modes:", flush=True)
    for old, new in RENAMED.items():
        print(f"  {old} -> {new}")

    if a.ablation_row:
        row = _row(a.ablation_row, lambda: one_ablation_row(
            a.ablation_row, device, a.quick))
        print(json.dumps(row))
        return 1 if "error" in row else 0

    header = _header(device)
    print(json.dumps(header), flush=True)
    sections = _names(a.only) or ["frames", "realtime", "interactive",
                                  "ablations"]
    unknown = set(sections) - {"frames", "realtime", "interactive",
                               "ablations"}
    if unknown:
        ap.error(f"unknown sections {sorted(unknown)}")
    rows, abl_names = _names(a.rows), _names(a.ablation_rows)
    missing = set(abl_names or ()) - set(ABLATION_MODES)
    if missing:
        ap.error(f"unknown ablation modes {sorted(missing)}")
    written = []
    results = {}
    for section, fn in (("frames", frame_rows), ("realtime", realtime_rows),
                        ("interactive", interactive_rows)):
        if section in sections:
            results.update(fn(device, a.quick, rows))
    if results:
        _write(os.path.join(a.out, "torch_results.json"), header, results)
        written.append(results)
    if "ablations" in sections:
        abl = ablation_rows(device, a.quick, abl_names)
        _write(os.path.join(a.out, "torch_ablations.json"), header, abl)
        written.append(abl)
    errors = [n for rs in written for n, r in rs.items() if "error" in r]
    if errors:
        print(f"gallery: {len(errors)} rows failed: {errors}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
