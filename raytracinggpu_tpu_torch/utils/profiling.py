"""Tracing and profiling (port of ``raytracinggpu_tpu/utils/profiling.py``):
the program's tracer (below), ``device_trace`` (a ``torch.profiler`` trace
written to a directory, the tracer's spans in it), ``ray_report`` (a
frame's ray counts from its TraceStats), and where a frame's time goes on
the card:

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

The tracer records the program's spans and counters at its layer
boundaries, in memory, on ``time.perf_counter_ns``:

- ``span(name, attr=None)``, a context manager: a span's name, its
  optional integer attribute (a depth index, a ray count; ``set_attr``
  sets it inside the span), its start and end, the span that encloses it
  and its request's id.  A span that no other encloses opens a new
  request (a frame, a loop step, a build): the spans inside it share its
  id.  ``request(name)`` is the span at an entry point;
- ``count(name, n=1)``: a named sum; ``timed(name)`` decorates a
  function whose calls add their host ns to ``<name>.ns`` and their
  number to ``<name>.calls``;
- ``tracing()`` (or ``enable()`` / ``disable()``) turns it on and off,
  ``collect()`` returns the record (``Trace``) of the last time it was
  on.  Besides, tracing follows a ``torch.profiler`` session: the first
  request that starts while one records turns tracing on with a new
  record, the first that starts after it ended turns it off.  So a
  profiled window holds both the profiler's events and the program's
  spans, and ``Trace.from_profiler_ns`` puts the first on the second's
  clock from the clock pairs the tracer reads when it turns on and off
  and at ``collect()`` (``time.perf_counter_ns`` beside
  ``time.time_ns``, the Unix-epoch clock of the profiler's events).  That
  holds for the profiler's host events (a kernel's launch call lies in
  the span that made it); its device events carry the CUDA profiling
  interface's own conversion of the device's clock, which can wander from
  the host's by up to milliseconds within a window (PERF.md), so a kernel
  is placed by its launch call.

Off, the default, ``span`` returns one shared object that does nothing
and ``count`` returns, each after one global check: no allocation and no
clock read.

The host build is the exception: a few spans a process, so
``build_span`` and ``build_count`` keep the build's spans (``build`` ⊃
``build.mesh`` ⊃ ``build.obj``, ``build.bvh``; ``build.tables`` ⊃
``build.upload``) and counters (``mesh.triangles``, ``pairs.tiles``,
``pairs.members``, ``ladder.key_boxes``) in a build record of their own
whether or not tracing is on, and in tracing's record too while it is
on.  ``collect()`` returns the build record as ``Trace.build``, beside
the record of tracing (whose spans and counters are then empty if
tracing never was on).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import importlib
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from time import perf_counter_ns
from typing import NamedTuple

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
    ("raytracinggpu_tpu_torch.ops.pairs_trace", "compact_bits"),
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


# ---------------------------------------------------------------- the tracer

class SpanRecord(NamedTuple):
    """One span of a ``Trace``: ``parent`` is the index in ``Trace.spans``
    of the span that encloses it (-1: none, it opened request ``frame``),
    ``end_ns`` None while it is open."""

    name: str
    attr: int | None
    start_ns: int
    end_ns: int | None
    parent: int
    frame: int


@dataclass
class Trace:
    """What the tracer kept while it was on: the spans in the order they
    started, the counters, and (perf_counter ns, profiler-clock ns) pairs
    read back to back."""

    spans: list
    counters: dict
    clocks: list
    build: Trace | None = None  # the build record (``build_span``)

    def self_ns(self) -> list:
        """Each closed span's duration less that of its closed children
        (None for an open span)."""
        out = [None if s.end_ns is None else s.end_ns - s.start_ns
               for s in self.spans]
        for s in self.spans:
            if s.parent >= 0 and s.end_ns is not None \
                    and out[s.parent] is not None:
                out[s.parent] -= s.end_ns - s.start_ns
        return out

    def _line(self) -> tuple:
        """(p0, a, b): the profiler clock less the span clock is a + b (p -
        p0) at span-clock time p, the line through the first and the last
        clock pair (b: the two clocks' drift)."""
        (p0, w0), (p1, w1) = self.clocks[0], self.clocks[-1]
        a = w0 - p0
        return p0, a, 0.0 if p1 == p0 else ((w1 - p1) - a) / (p1 - p0)

    def from_profiler_ns(self, t_ns: int) -> int:
        """A ``torch.profiler`` timestamp (Unix-epoch ns) on the span
        clock (perf_counter ns)."""
        p0, a, b = self._line()
        q = int(t_ns) - a
        return q - round(b * (q - p0) / (1.0 + b))

    def to_profiler_ns(self, t_ns: int) -> int:
        """A span-clock time on the ``torch.profiler`` clock."""
        p0, a, b = self._line()
        return int(t_ns) + a + round(b * (int(t_ns) - p0))


def _clock_pair() -> tuple:
    """(perf_counter ns, time_ns) read back to back: of three tries, the
    one whose two perf_counter reads lie closest, at their middle."""
    best = None
    for _ in range(3):
        a = perf_counter_ns()
        w = time.time_ns()
        b = perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, w)
    return best[1], best[2]


class _Recorder:
    """The record being written: one row (name, attr, start, end, parent,
    request) a span, None until the span ends; the open spans, outermost
    first; counters; clock pairs."""

    __slots__ = ("spans", "stack", "counters", "clocks", "frames")

    def __init__(self):
        self.spans, self.stack, self.counters = [], [], {}
        self.clocks = [_clock_pair()]
        self.frames = 0

    def trace(self) -> Trace:
        spans = [None if row is None else SpanRecord(*row)
                 for row in self.spans]
        for k, open_ in enumerate(self.stack):
            spans[open_.index] = SpanRecord(
                open_.name, open_.attr, open_.t0,
                None, self.stack[k - 1].index if k else -1, self.frames)
        return Trace(spans, dict(self.counters), list(self.clocks))


class _Span:
    __slots__ = ("rec", "name", "attr", "index", "t0", "t1")

    def __init__(self, rec, name, attr):
        self.rec, self.name, self.attr = rec, name, attr

    def __enter__(self):
        rec = self.rec
        if not rec.stack:
            rec.frames += 1
        self.index = len(rec.spans)
        rec.spans.append(None)
        rec.stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = perf_counter_ns()
        rec = self.rec
        stack = rec.stack
        stack.pop()
        # a row of atoms only: the garbage collector stops tracking it
        rec.spans[self.index] = (self.name, self.attr, self.t0, self.t1,
                                 stack[-1].index if stack else -1,
                                 rec.frames)
        return False

    def set_attr(self, attr) -> None:
        self.attr = attr

    @property
    def ns(self) -> int:
        """The span's duration, once it ended."""
        return self.t1 - self.t0


class _Off:
    """The span while tracing is off: it does nothing."""

    __slots__ = ()
    ns = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set_attr(self, attr) -> None:
        pass


_OFF = _Off()
_REC = None          # the record being written; None: tracing is off
_BUILD = _Recorder()  # the build record, kept whether tracing is on or not
_LAST = None         # the record of the last time tracing was on
_BY_PROFILER = False  # tracing was turned on by a torch.profiler session
_profiler_on = torch._C._autograd._profiler_enabled


def span(name: str, attr=None):
    """A span of the program (see the module's docstring); with tracing
    off, the shared object that does nothing."""
    if _REC is None:
        return _OFF
    return _Span(_REC, name, attr)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter ``name`` while tracing is on."""
    if _REC is None:
        return
    c = _REC.counters
    c[name] = c.get(name, 0) + n


class _BuildSpan:
    """A span of the host build: one in the build record, and one in
    tracing's record while tracing is on."""

    __slots__ = ("spans",)

    def __init__(self, name, attr):
        self.spans = [_Span(_BUILD, name, attr)]
        if _REC is not None:
            self.spans.append(_Span(_REC, name, attr))

    def __enter__(self):
        for s in self.spans:
            s.__enter__()
        return self

    def __exit__(self, *exc):
        for s in reversed(self.spans):
            s.__exit__(*exc)
        return False


def build_span(name: str, attr=None):
    """A span of the host build, kept whether or not tracing is on (see
    the module's docstring)."""
    return _BuildSpan(name, attr)


def build_count(name: str, n: int = 1) -> None:
    """Add n to the build record's counter ``name``, and to tracing's
    while it is on."""
    for rec in (_BUILD, _REC):
        if rec is not None:
            rec.counters[name] = rec.counters.get(name, 0) + n


def timed(name: str):
    """Decorate a function so that, while tracing is on, each call adds
    its host ns to the counter ``<name>.ns`` and one to ``<name>.calls``."""
    ns_key, calls_key = f"{name}.ns", f"{name}.calls"

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            rec = _REC
            if rec is None:
                return fn(*args, **kwargs)
            t0 = perf_counter_ns()
            try:
                return fn(*args, **kwargs)
            finally:
                c = rec.counters
                c[ns_key] = c.get(ns_key, 0) + perf_counter_ns() - t0
                c[calls_key] = c.get(calls_key, 0) + 1
        return call
    return wrap


def enable() -> bool:
    """Turn tracing on with a new record; False (and nothing done) when it
    is on already."""
    global _REC, _BY_PROFILER
    if _REC is not None:
        return False
    _REC, _BY_PROFILER = _Recorder(), False
    return True


def disable() -> None:
    """Turn tracing off; ``collect()`` then returns its record."""
    global _REC, _LAST, _BY_PROFILER
    if _REC is not None:
        _REC.clocks.append(_clock_pair())
        _LAST, _REC, _BY_PROFILER = _REC, None, False


def collect() -> Trace | None:
    """The record of tracing while it is on (a clock pair read now added),
    else of the last time it was on, with the build record as its
    ``build``; None if tracing never was on and nothing was built."""
    if _REC is not None:
        _REC.clocks.append(_clock_pair())
        trace = _REC.trace()
    elif _LAST is not None:
        trace = _LAST.trace()
    elif _BUILD.spans or _BUILD.counters:
        trace = Trace([], {}, [_clock_pair()])
    else:
        return None
    trace.build = _BUILD.trace()
    return trace


@contextlib.contextmanager
def tracing():
    """Tracing on for the block (sharing the record when it is on
    already); yields nothing: ``collect()`` after the block reads it."""
    started = enable()
    try:
        yield
    finally:
        if started:
            disable()


def open_spans() -> list:
    """(name, attribute) of each span open now, the outermost first; none
    while tracing is off."""
    if _REC is None:
        return []
    return [(s.name, s.attr) for s in _REC.stack]


def request(name: str, attr=None):
    """The span of a request's entry point (a frame, a loop step): a
    ``span``, which besides turns tracing on when a ``torch.profiler``
    session records and tracing is off, and off when tracing was turned on
    by a session that has ended."""
    global _BY_PROFILER
    if _profiler_on():
        if enable():
            _BY_PROFILER = True
    elif _BY_PROFILER:
        disable()
    return span(name, attr)


def _write_spans(path: str, trace: Trace) -> None:
    """Add the trace's closed spans to the Chrome trace at ``path`` as
    complete events of one thread, "program spans", of this process, on
    the profiler's clock (the file's times are us from its
    ``baseTimeNanoseconds``)."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), 0
    events = doc.setdefault("traceEvents", [])
    events.append({"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                   "args": {"name": "program spans"}})
    for s in trace.spans:
        if s.end_ns is None:
            continue
        events.append({
            "name": s.name, "ph": "X", "cat": "program", "pid": pid,
            "tid": tid, "ts": (trace.to_profiler_ns(s.start_ns) - base) / 1e3,
            "dur": (s.end_ns - s.start_ns) / 1e3,
            "args": {"attr": s.attr, "frame": s.frame}})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def device_trace(out_dir: str | None):
    """A ``torch.profiler`` trace of the block (host and, with a CUDA
    device, the card), with the tracer on and its spans added, written to
    ``out_dir``/trace.json in the Chrome trace format (chrome://tracing,
    Perfetto); nothing when out_dir is None."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof, tracing():
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, collect())


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
