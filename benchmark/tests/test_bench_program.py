"""The readers of the program's own tracer on synthetic runs: the
launch wrappers' host time, the device's idle time inside the mesh
casts, the ladder's fill, each None without a program record; and the
interval arithmetic under them."""
from __future__ import annotations

import types

import pytest

from benchmark import program, spec
from benchmark.run import Run
from raytracinggpu_tpu_torch.utils.profiling import SpanRecord, Trace

NEW = ("launch_host_us", "cast_idle_ms_per_frame", "ladder_fill_pct")


def fake_run(arrivals, ops=None, trace=None):
    cell = types.SimpleNamespace(
        traffic={"spp": 32, "max_depth": 5},
        config={"view": {"width": 512, "height": 512}})
    run = Run(cell, None)
    run.t0, run.arrivals = 0.0, list(arrivals)
    run.t_end = run.arrivals[-1]
    run.ops = ops
    run.program_trace = trace
    return run


def value(metric, run):
    return spec.reader(metric)(run)


def span(name, a, b, parent=-1, frame=1, attr=None):
    return SpanRecord(name, attr, int(a * 1e9), int(b * 1e9), parent, frame)


@pytest.mark.parametrize("a,b,both", [
    ([], [(0, 1)], 0.0),
    ([(0, 2)], [(1, 3)], 1.0),
    ([(0, 1), (2, 3)], [(0.5, 2.5)], 1.0),
    ([(0, 4), (1, 2)], [(1.5, 5), (6, 7)], 2.5),
])
def test_overlap(a, b, both):
    assert program.overlap(a, b) == pytest.approx(both)
    assert program.overlap(b, a) == pytest.approx(both)


def test_readers_return_nothing_without_a_program_record():
    run = fake_run([0.5, 1.0], ops=[("k", 0.0, 0.1)])
    for m in NEW:
        assert value(m, run) is None
    empty = Trace([], {}, [(0, 0)])
    run = fake_run([0.5, 1.0], ops=[("k", 0.0, 0.1)], trace=empty)
    for m in NEW:
        assert value(m, run) is None


def test_program_record_of_a_program_without_a_tracer(monkeypatch):
    from raytracinggpu_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "collect")
    run = fake_run([0.5, 1.0])
    del run.program_trace
    assert program.of(run) is None
    for m in NEW:
        assert value(m, run) is None


def test_a_record_of_another_window_is_not_read(monkeypatch):
    from raytracinggpu_tpu_torch.utils import profiling

    c = {"launch.shade.ns": 30_000, "launch.shade.calls": 2}
    old = Trace([span("frame", 5.0, 6.0)], c, [(0, 0)])
    monkeypatch.setattr(profiling, "collect", lambda: old)
    run = fake_run([0.5, 1.0])
    del run.program_trace
    assert program.of(run) is None
    assert value("launch_host_us", run) is None


def test_launch_host_us():
    c = {"launch.shade.ns": 30_000, "launch.shade.calls": 2,
         "launch.scatter.ns": 10_000, "launch.scatter.calls": 2,
         "ladder.casts": 7}
    run = fake_run([1.0], trace=Trace([], c, [(0, 0)]))
    assert value("launch_host_us", run) == pytest.approx(10.0)


def test_cast_idle_ms_per_frame():
    # the device busy [0, 1], [2, 3], [5, 6] of [0, 7]; idle 1-2, 3-5, 6-7
    ops = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k1", 5.0, 6.0)]
    spans = [span("frame", 0.0, 7.0), span("cast.closest", 0.5, 2.5, 0),
             span("ladder.wait", 1.2, 1.8, 1), span("shade", 2.5, 3.5, 0),
             span("cast.shadow", 4.0, 6.5, 0),
             # outside the window
             span("cast.shadow", 7.5, 8.0, 0)]
    run = fake_run([3.5, 7.0], ops=ops, trace=Trace(spans, {}, [(0, 0)]))
    # inside the casts: 1-2 (1.0), 4-5 (1.0), 6-6.5 (0.5): 2.5 s, 2 frames
    assert value("cast_idle_ms_per_frame", run) == pytest.approx(1250.0)


def test_ladder_fill_pct():
    c = {"ladder.casts": 5, "ladder.compacted": 3, "ladder.active": 900,
         "ladder.capacity": 1200}
    run = fake_run([1.0], trace=Trace([], c, [(0, 0)]))
    assert value("ladder_fill_pct", run) == pytest.approx(75.0)
