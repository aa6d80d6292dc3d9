"""Tracing and profiling (port of ``raytracinggpu_tpu/utils/profiling.py``):
``PhaseTimer``, ``device_trace`` (a ``torch.profiler`` trace written to a
directory), ``ray_report`` (a frame's ray counts from its TraceStats), and
where a frame's time goes on the card:

    python -m raytracinggpu_tpu_torch.utils.profiling [--preset P]
        [--traversal T] [--obj PATH [--bvh-builder B]] [--out FILE.json]

Renders a frame of preset P with mesh traversal T (``pairs``, the
default, ``pallas`` or ``dense``) on the first CUDA device: the
main-path frame (``array_bvh``, 512x512, spp 32, depth 5; the default),
the realtime loop's frame (``realtime``, 512x512, spp 20, depth 3, its
default camera; the loop adds only the accumulation and the tone map), or
with ``--obj`` the big-mesh frame of ``bench/big_mesh.py`` (the OBJ in the
cat's place, built with BVH builder B, 512x512, spp 4, depth 2).
One frame warms up, then one frame for each of

- ``frame_ms``: host clock around the frame, ended by
  ``torch.cuda.synchronize()``, no profiler;
- the device trace: ``torch.profiler`` over one frame.  ``kernel_ms`` is
  the union of the device kernels' intervals (one stream, so also their
  sum), ``busy`` = kernel_ms / frame_ms (the share of an unprofiled
  frame the card spends in kernels), and the kernels by name;
- the stage breakdown: each stage function wrapped in
  ``torch.cuda.synchronize()`` before and after, so stages are timed
  alone but host and card are serialised: the frame is slower, and
  nested stages (``STAGES`` lists parents first) count inside their
  parents.

Prints a readable report and, with ``--out``, writes it as JSON.  Without
a CUDA device it exits nonzero.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

# (module, function) of each stage, looked up where the caller finds it
STAGES = (
    ("raytracinggpu_tpu_torch.render.pipeline", "trace"),
    ("raytracinggpu_tpu_torch.render.pipeline", "primary_rays"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "_mesh_closest"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "_mesh_shadow"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "intersect_spheres"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "shade"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "sphere_shadow"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "bounce"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "composite"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_pair_bits"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_shadow"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_closest"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_closest_smooth"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_ray_feature_rows"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_compact_key"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_tier"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_live_rows"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_compact_sort"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "compact_rows"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "scatter"),
    ("raytracinggpu_tpu_torch.ops.pallas_trace", "_block_active_tiles"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pallas_closest"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pallas_shadow"),
    ("raytracinggpu_tpu_torch.ops.pallas_trace", "_ray_features16"),
)

# the frame each preset is profiled at (realtime: the preset's own size)
PRESETS = {"array_bvh": dict(width=512, height=512, spp=32, max_depth=5),
           "realtime": {}}
# the frame of a custom mesh (--obj): bench/big_mesh.py's
OBJ_FRAME = dict(width=512, height=512, spp=4, max_depth=2)


@dataclass
class PhaseTimer:
    """Named host-clock phases; synchronise the device before a phase ends
    to time device work."""

    phases: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = (self.phases.get(name, 0.0)
                                 + time.perf_counter() - t0)

    def report(self) -> str:
        total = sum(self.phases.values())
        return " | ".join(f"{k}: {v:.3f}s ({v / total:.0%})"
                          for k, v in self.phases.items())


@contextlib.contextmanager
def device_trace(out_dir: str | None):
    """A ``torch.profiler`` trace of the block (host and, with a CUDA
    device, the card), written to ``out_dir``/trace.json in the Chrome
    trace format (chrome://tracing, Perfetto); nothing when out_dir is
    None."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))


def ray_report(stats, spp: int, width: int, height: int, wall_s: float) -> dict:
    """A frame's ray counts from its TraceStats (numpy arrays or tensors):
    primary, bounce (the hits of every depth) and shadow (the diffuse
    lanes of every depth) rays, their rate over ``wall_s`` and the per-depth
    histograms."""
    a = lambda x: np.asarray(x.cpu() if hasattr(x, "cpu") else x, np.int64)
    hit, diffuse = a(stats.hit), a(stats.diffuse)
    primary = width * height * spp
    bounce, shadow = int(hit.sum()), int(diffuse.sum())
    total = primary + bounce + shadow
    return {
        "primary_rays": primary,
        "bounce_rays": bounce,
        "shadow_rays": shadow,
        "total_rays": total,
        "mrays_per_sec": total / wall_s / 1e6 if wall_s > 0 else 0.0,
        "bounce_histogram": hit.tolist(),
        "tir_histogram": a(stats.tir).tolist(),
        "shadowed_histogram": a(stats.shadowed).tolist(),
    }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_ms(fn, device) -> float:
    """Host-clock time of fn() in ms, ended by a device synchronise."""
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def stage_timers(device, stages=STAGES, events: bool = False):
    """Wrap each stage function so that every call is synchronised and
    timed; yields {stage: [ms, calls]} and restores the functions on
    exit.  ``events`` (a CUDA device): time each call between two CUDA
    events instead of the host clock, leaving out the synchronisation."""
    out = defaultdict(lambda: [0.0, 0])
    saved = []

    def timed(name, fn):
        def call(*a, **k):
            _sync(device)
            if events:
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            if events:
                end.record()
            _sync(device)
            out[name][0] += (start.elapsed_time(end) if events
                             else (time.perf_counter() - t0) * 1e3)
            out[name][1] += 1
            return r
        return call

    try:
        for mod_name, attr in stages:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            saved.append((mod, attr, fn))
            setattr(mod, attr, timed(attr, fn))
        yield out
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def device_kernels(fn, top: int = 12) -> dict:
    """Run fn() under torch.profiler and sum the CUDA kernels it ran:
    count, union of their intervals (ms) and the ``top`` names by time.
    Only the CUDA activity is traced: the host's operator events, hundreds
    of thousands in a frame, are not collected."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            s, t = e.time_range.start, e.time_range.end
            spans.append((s, t))
            by_name[e.name][0] += (t - s) / 1e3
            by_name[e.name][1] += 1
    spans.sort()
    union, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            union += t - max(s, end)
            end = t
    names = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"kernels": len(spans), "kernel_ms": union / 1e3,
            "by_name": [{"name": n[:120], "ms": ms, "count": c}
                        for n, (ms, c) in names]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=PRESETS, default="array_bvh")
    ap.add_argument("--traversal", choices=("pairs", "pallas", "dense"),
                    default="pairs")
    ap.add_argument("--obj", metavar="PATH",
                    help="profile this OBJ in the cat's place, at "
                         "bench/big_mesh.py's frame size")
    ap.add_argument("--bvh-builder", choices=("reference", "lbvh"),
                    default="reference")
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1

    from raytracinggpu_tpu_torch.api import Renderer
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    r = Renderer(args.preset, obj_path=args.obj, bvh_builder=args.bvh_builder,
                 device=dev, traversal=args.traversal,
                 **(OBJ_FRAME if args.obj else PRESETS[args.preset]))
    build_s = time.perf_counter() - t0
    cfg, tables = r.cfg, r.scene
    cam = Camera.default(cfg, dev)
    frame = lambda seed: render_frame(tables, cfg, cam, PRNGKey(seed, dev))

    frame(0)  # warm-up: builds the kernels, fills the allocator
    torch.cuda.reset_peak_memory_stats(dev)
    frame_ms = wall_ms(lambda: frame(1), dev)
    peak = torch.cuda.max_memory_allocated(dev)
    kern = device_kernels(lambda: frame(2))
    with stage_timers(dev) as stages:
        sync_ms = wall_ms(lambda: frame(3), dev)
    report = {
        "card": card[0] if card else "not read",
        "config": f"{args.preset} {cfg.width}x{cfg.height} spp{cfg.spp} "
                  f"d{cfg.max_depth} {cfg.traversal}"
                  + (f" obj {os.path.basename(args.obj)} "
                     f"({args.bvh_builder} BVH, subgroup "
                     f"{cfg.pairs_subgroup})" if args.obj else ""),
        "host_build_s": build_s,
        "frame_ms": frame_ms, "peak_bytes": peak, **kern,
        "busy": kern["kernel_ms"] / frame_ms,
        "synchronised_frame_ms": sync_ms,
        "stages": [{"stage": a, "ms": stages[a][0], "calls": stages[a][1]}
                   for _, a in STAGES if a in stages],
    }
    print(f"card {report['card']}; {report['config']}; scene built in "
          f"{build_s:.2f} s")
    print(f"frame {frame_ms:.1f} ms unprofiled, peak memory "
          f"{peak / 2**30:.3f} GiB; profiled: {kern['kernels']} kernels, "
          f"{kern['kernel_ms']:.1f} ms, busy {report['busy']:.3f}")
    for k in kern["by_name"]:
        print(f"  {k['ms']:9.1f} ms {k['count']:7d}x  {k['name']}")
    print(f"synchronised frame {sync_ms:.1f} ms; stages (ms, calls):")
    for s in report["stages"]:
        print(f"  {s['stage']:20s} {s['ms']:9.1f} {s['calls']:6d}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
