"""What the program's own tracer recorded in a traced run.

``raytracinggpu_tpu_torch/utils/profiling.py`` keeps spans and counters
at the program's layer boundaries while a ``torch.profiler`` session
records: the traced window's ``trace.DeviceWindow`` is one, so the
program's record (``collect()``) covers the window and the warm-up frame
before it.  Its spans are on ``time.perf_counter_ns``, the clock of the
run's window and of ``run.ops``.  A program without the tracer gives no
record, and each reader of one then returns None."""
from __future__ import annotations

from benchmark import frozen

CASTS = ("cast.closest", "cast.shadow")


def of(run):
    """The program's record for ``run`` (kept on it as
    ``program_trace``), or None where the program has no tracer or its
    last record holds no span of the run's window."""
    if not hasattr(run, "program_trace"):
        trace = _collect()
        if trace is not None and not spans_in(trace, run.t0, run.t_end):
            trace = None
        run.program_trace = trace
    return run.program_trace


def _collect():
    try:
        from raytracinggpu_tpu_torch.utils import profiling
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    return None if collect is None else collect()


def spans_in(trace, lo: float, hi: float, names=None) -> list:
    """(start, end) in perf_counter seconds of the closed spans named in
    ``names`` (all where None), cut to [lo, hi]; those outside it left
    out."""
    out = []
    for s in trace.spans:
        if s.end_ns is None or (names is not None and s.name not in names):
            continue
        a, b = max(s.start_ns * 1e-9, lo), min(s.end_ns * 1e-9, hi)
        if b > a:
            out.append((a, b))
    return out


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """The length of the intersection of the unions of two lists of
    (start, end) intervals."""
    a, b = _union(a), _union(b)
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_inside(run, spans) -> float:
    """Seconds of the window's device idle time (the gaps of the union of
    ``run.ops`` over [run.t0, run.t_end]) that lie inside ``spans``."""
    gaps = frozen.idle_gaps([(s, e) for _, s, e in run.ops], run.t0,
                            run.t_end)
    return overlap(gaps, spans)
