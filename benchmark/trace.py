"""The traced run's instruments, all in the benchmark's own files: host
spans and counters recorded by wrappers around the program's calls into
each layer, and the device's operations from ``torch.profiler`` (CUDA
activity only) over the same window.

``Spans`` wraps, for the length of a ``with`` block, functions that the
program looks up by module attribute at each call: the render, the trace,
the primary rays, each depth step, each mesh cast (closest or shadow) and
the ladder's wait for a cast's count (``frozen.TierWait``).  ``DeviceWindow``
profiles the window and puts the device's timeline on the host clock by a
marker operation launched on an idle card."""
from __future__ import annotations

import importlib
import re
import time
from collections import defaultdict

import torch

from benchmark import frozen

PKG = "raytracinggpu_tpu_torch"
# (module, attribute, span name) of every function a traced run wraps
SPANNED = (
    ("render.pipeline", "render_frame", "render"),
    ("render.realtime", "render_rows", "render"),
    ("render.pipeline", "primary_rays", "primary_rays"),
    ("integrator.wavefront", "shade", "shade"),
    ("integrator.wavefront", "bounce", "bounce"),
    ("integrator.wavefront", "intersect_spheres", "spheres"),
    ("integrator.wavefront", "composite", "composite"),
)
CASTS = (("integrator.wavefront", "intersect_tris_pairs", "cast.closest"),
         ("integrator.wavefront", "intersect_tris_pairs_shadow",
          "cast.shadow"))


class Spans:
    """Host spans (name, start, end) on ``time.perf_counter``, the depth of
    every mesh cast, and the ladder's tier and wait a cast.  ``span`` may
    also be used by the caller for its own phases."""

    def __init__(self):
        self.spans = []
        self.here = {"depth": -1}
        self.casts = defaultdict(int)   # depth -> mesh casts
        self.tiers = frozen.TierWait(self.here)
        self._saved = []

    def span(self, name: str):
        spans = self.spans

        class _Span:
            def __enter__(self):
                self.t0 = time.perf_counter()

            def __exit__(self, *exc):
                spans.append((name, self.t0, time.perf_counter()))
        return _Span()

    def _wrap(self, name, fn):
        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                self.spans.append((name, t0, time.perf_counter()))
        return call

    def _patch(self, mod, attr, wrapper):
        m = importlib.import_module(f"{PKG}.{mod}")
        fn = getattr(m, attr)
        self._saved.append((m, attr, fn))
        setattr(m, attr, wrapper(fn))

    def __enter__(self):
        here = self.here

        def trace(fn):
            def call(*a, **k):
                here["depth"] = -1
                return self._wrap("trace", fn)(*a, **k)
            return call

        def depth_step(fn):
            def call(*a, **k):
                here["depth"] += 1
                return self._wrap("depth_step", fn)(*a, **k)
            return call

        def cast(name):
            def wrap(fn):
                def call(*a, **k):
                    self.casts[here["depth"]] += 1
                    return self._wrap(name, fn)(*a, **k)
                return call
            return wrap

        for mod, attr, name in SPANNED:
            self._patch(mod, attr, lambda fn, name=name: self._wrap(name, fn))
        self._patch("render.pipeline", "trace", trace)
        self._patch("integrator.wavefront", "_depth_step", depth_step)
        for mod, attr, name in CASTS:
            self._patch(mod, attr, cast(name))
        self._patch("ops.pairs_trace", "_tier",
                    lambda fn: self._wrap("ladder_wait",
                                          self.tiers.wrap(fn)))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in reversed(self._saved):
            setattr(m, attr, fn)
        self._saved.clear()


class MeshWork:
    """For the length of a ``with`` block, count the Moller-Trumbore tests
    the inputs of every pairs mesh cast need: for each ray, the triangles
    of every finest (member) box of the cast's tables that the ray enters
    over the interval it is given (up to ``cap``; a shadow cast's inactive
    lanes none), with the frozen slab test.  ``tests`` holds the sum."""

    BOXES = 64  # member boxes a slab test block holds

    def __init__(self):
        self.tests = 0
        self._saved = []

    def _count(self, O, u, tab, cap, active):
        Ot = torch.stack(tuple(O))
        ut = torch.stack(tuple(u))
        slots = tab.member_slot.long()
        nm = tab.member_aabb.shape[0]
        per = torch.bincount(slots[slots >= 0], minlength=nm).to(torch.float64)
        total = torch.zeros((), dtype=torch.float64, device=Ot.device)
        for b0 in range(0, nm, self.BOXES):
            enter, _, hit = frozen.slab_enter_exit(
                Ot, ut, tab.member_aabb[b0:b0 + self.BOXES])
            if cap is not None:
                hit = hit & (enter <= cap[None, :])
            if active is not None:
                hit = hit & active[None, :]
            total += (hit.sum(1).to(torch.float64)
                      * per[b0:b0 + self.BOXES]).sum()
        self.tests += float(total)

    def __enter__(self):
        wf = importlib.import_module(f"{PKG}.integrator.wavefront")

        def closest(fn):
            def call(O, u, tab, eps_leaf, cap=None, **k):
                self._count(O, u, tab, cap, None)
                return fn(O, u, tab, eps_leaf, cap=cap, **k)
            return call

        def shadow(fn):
            def call(O, u, tab, eps_leaf, cap=None, active=None, **k):
                self._count(O, u, tab, cap, active)
                return fn(O, u, tab, eps_leaf, cap=cap, active=active, **k)
            return call

        for attr, wrap in (("intersect_tris_pairs", closest),
                           ("intersect_tris_pairs_shadow", shadow)):
            fn = getattr(wf, attr)
            self._saved.append((wf, attr, fn))
            setattr(wf, attr, wrap(fn))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in reversed(self._saved):
            setattr(m, attr, fn)
        self._saved.clear()


def _short(name: str) -> str:
    """A device operation's name without its namespaces and argument
    list, for the breakdown."""
    name = re.sub(r"\(anonymous namespace\)::|at::native::|at::cuda::", "",
                  name)
    return re.sub(r"^void |\(.*", "", name).strip()[:120]


class DeviceWindow:
    """``torch.profiler`` over a window, CUDA activity only.  ``start``
    launches a marker on the idle card, so the first device operation of
    the trace is the marker and gives the offset of the device's clock
    against ``time.perf_counter``; ``stop`` returns the window's
    operations as (name, start, end) in perf_counter seconds."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.h0 = None

    def start(self):
        torch.cuda.synchronize()
        self.prof.__enter__()
        time.sleep(0.2)  # let the tracer start before the marker
        marker = torch.empty(1, device="cuda")
        self.h0 = time.perf_counter()
        marker.fill_(0.0)
        torch.cuda.synchronize()

    def stop(self):
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        ops = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                ops.append((e.name(), e.start_ns() * 1e-9,
                            (e.start_ns() + e.duration_ns()) * 1e-9))
        ops.sort(key=lambda o: o[1])
        if not ops:
            return []
        off = ops[0][1] - self.h0   # the marker
        return [(n, s - off, t - off) for n, s, t in ops[1:]]


def innermost(spans):
    """Cut nested host spans (name, start, end) into consecutive segments
    (start, end, name of the innermost open span)."""
    segs, stack, cur = [], [], None

    def emit(upto):
        nonlocal cur
        if stack and cur is not None and upto > cur:
            segs.append((cur, upto, stack[-1][0]))
        cur = upto

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            emit(stack[-1][2])
            stack.pop()
        emit(s)
        stack.append((name, s, e))
    while stack:
        emit(stack[-1][2])
        stack.pop()
    return segs


def breakdown(ops, spans, lo: float, hi: float) -> dict:
    """The ten device operations that took most time, by name, and the
    ten largest sums of the device's idle time in [lo, hi] by what the
    host was doing: the innermost host span at the middle of each gap
    ("outside spans" where none was open)."""
    by_name = defaultdict(float)
    for n, s, e in ops:
        by_name[_short(n)] += e - s
    idle = defaultdict(float)
    segs, k = innermost(spans), 0
    for g0, g1 in frozen.idle_gaps([(s, e) for _, s, e in ops], lo, hi):
        mid = 0.5 * (g0 + g1)
        while k < len(segs) and segs[k][1] < mid:
            k += 1
        inside = k < len(segs) and segs[k][0] <= mid
        idle[segs[k][2] if inside else "outside spans"] += g1 - g0
    top = lambda d: [[n, v] for n, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(by_name), "idle_gaps": top(idle)}
