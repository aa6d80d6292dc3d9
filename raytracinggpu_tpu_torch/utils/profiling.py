"""Where a frame's time goes on the card (counterpart of
``raytracinggpu_tpu/utils/profiling.py``).

    python -m raytracinggpu_tpu_torch.utils.profiling [--preset P]
        [--traversal T] [--out FILE.json]

Renders a frame of preset P with mesh traversal T (``pairs``, the
default, ``pallas`` or ``dense``) on the first CUDA device: the
main-path frame (``array_bvh``, 512x512, spp 32, depth 5; the default) or
the realtime loop's frame (``realtime``, 512x512, spp 20, depth 3, its
default camera; the loop adds only the accumulation and the tone map).
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
import subprocess
import sys
import time
from collections import defaultdict

import torch

# (module, function) of each stage, looked up where the caller finds it
STAGES = (
    ("raytracinggpu_tpu_torch.render.pipeline", "trace"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "intersect_all"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "occlusion_distance"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_pair_bits"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "intersect_spheres"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_shadow"),
    ("raytracinggpu_tpu_torch.render.pipeline", "row_uniforms"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_closest"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pairs_closest_smooth"),
    ("raytracinggpu_tpu_torch.integrator.wavefront", "cosine_hemisphere"),
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "_ray_feature_rows"),
    ("raytracinggpu_tpu_torch.ops.pallas_trace", "_block_active_tiles"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pallas_closest"),
    ("raytracinggpu_tpu_torch.ops._kernels", "pallas_shadow"),
    ("raytracinggpu_tpu_torch.ops.pallas_trace", "_ray_features16"),
)

# the frame each preset is profiled at (realtime: the preset's own size)
PRESETS = {"array_bvh": dict(width=512, height=512, spp=32, max_depth=5),
           "realtime": {}}


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
def stage_timers(device, stages=STAGES):
    """Wrap each stage function so that every call is synchronised and
    timed; yields {stage: [ms, calls]} and restores the functions on
    exit."""
    out = defaultdict(lambda: [0.0, 0])
    saved = []

    def timed(name, fn):
        def call(*a, **k):
            _sync(device)
            t0 = time.perf_counter()
            r = fn(*a, **k)
            _sync(device)
            out[name][0] += (time.perf_counter() - t0) * 1e3
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
    count, union of their intervals (ms) and the ``top`` names by time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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
    ap.add_argument("--out", help="write the report here as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiling: no CUDA device", file=sys.stderr)
        return 1

    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    cfg, tables = build_preset(args.preset, dev, traversal=args.traversal,
                               **PRESETS[args.preset])
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
                  f"d{cfg.max_depth} {cfg.traversal}",
        "frame_ms": frame_ms, "peak_bytes": peak, **kern,
        "busy": kern["kernel_ms"] / frame_ms,
        "synchronised_frame_ms": sync_ms,
        "stages": [{"stage": a, "ms": stages[a][0], "calls": stages[a][1]}
                   for _, a in STAGES if a in stages],
    }
    print(f"card {report['card']}; {report['config']}")
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
