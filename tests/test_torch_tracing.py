"""The program's tracer (raytracinggpu_tpu_torch/utils/profiling.py): off,
it records nothing; on, a small array_bvh frame and two realtime steps
give the span tree of the layers, one request id a frame, two mesh casts
a depth step and self times >= 0; the ladder's counters agree with the
benchmark's wrapper of ``_tier`` (``benchmark/frozen.TierWait``) cast by
cast; the clock pairs put a ``torch.profiler`` event inside the span it
ran in; tracing follows a profiler session; ``device_trace`` writes the
spans into its trace; the launch wrappers count their host time; and
``run_loop`` times every display's arrival."""
import io
import json
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import frozen
from raytracinggpu_tpu_torch import Renderer
from raytracinggpu_tpu_torch.bench.ladder import TierLog, ladder_casts
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.render import realtime as rt
from raytracinggpu_tpu_torch.utils import profiling

torch.set_num_threads(2)

# a small frame whose depth-1 casts run the ladder (blocks of 128 rays)
SMALL = dict(width=24, height=24, spp=2, max_depth=2, pairs_block=128)

# the names a span may have, each with the names its parent may have
# (None: it opens a request)
PARENTS = {
    "build": {None},
    "build.mesh": {"build"},
    "build.obj": {"build.mesh"},
    "build.bvh": {"build.mesh"},
    "build.tables": {"build"},
    "build.upload": {"build.tables"},
    "frame": {None},
    "frame.readback": {"frame"},
    "step": {None},
    "step.accumulate_tonemap": {"step"},
    "render": {"frame", "step"},
    "primary_rays": {"render"},
    "trace": {"render"},
    "depth": {"trace"},
    "spheres": {"depth"},
    "cast.closest": {"depth"},
    "cast.shadow": {"depth"},
    "shade": {"depth"},
    "bounce": {"depth"},
    "composite": {"trace"},
    "ladder": {"cast.closest", "cast.shadow"},
    "ladder.key": {"ladder"},
    "ladder.wait": {"ladder"},
    "ladder.sort": {"ladder"},
    "ladder.bits": {"ladder"},
    "cast.rows_bits": {"ladder", "cast.closest", "cast.shadow"},
    "cast.kernel": {"cast.closest", "cast.shadow"},
    "ladder.scatter": {"cast.closest", "cast.shadow"},
}


def _requests():
    """A Renderer's build, one array_bvh frame and two realtime steps."""
    r = Renderer("array_bvh", device="cpu", **SMALL)
    r.render_hdr(seed=3)
    loop = Renderer("realtime", device="cpu", **SMALL)
    state = rt.init_state(loop.cfg, loop.scene, seed=1)
    for _ in range(2):
        state, _ = rt.step(loop.scene, loop.cfg, state)


@pytest.fixture(scope="module")
def traced():
    """The record of ``_requests`` with tracing on, and the log of
    ``frozen.TierWait`` around ``_tier`` with the count behind each cast
    (the count's host copy, read after the wait)."""
    tier = ppt._tier
    waits = frozen.TierWait({})
    counts = []

    def recording(tiers, pending):
        C = tier(tiers, pending)
        counts.append(int(pending[0]))
        return C

    ppt._tier = waits.wrap(recording)
    try:
        with profiling.tracing():
            _requests()
    finally:
        ppt._tier = tier
    return profiling.collect(), waits.log, counts


def _window(trace):
    """The spans and counters of tracing's own record in ``trace``."""
    return ([], {}) if trace is None else (trace.spans, trace.counters)


def test_tracing_off_records_nothing():
    """Off, tracing's record stays as it was; only the build record,
    kept whether or not tracing is on, takes the Renderer's build."""
    before = profiling.collect()
    assert profiling.span("a") is profiling.span("b", 3)
    with profiling.span("a") as s:
        s.set_attr(1)
        profiling.count("n", 5)
    assert s.ns == 0 and profiling.open_spans() == []
    r = Renderer("array_bvh", device="cpu", width=8, height=8, spp=1,
                 max_depth=1)
    r.render_hdr(seed=0)
    after = profiling.collect()
    assert _window(after) == _window(before)
    n = 0 if before is None else len(before.build.spans)
    assert [s.name for s in after.build.spans[n:]] == [
        "build", "build.mesh", "build.obj", "build.bvh", "build.tables",
        "build.upload"]


def test_spans_nest_by_layer(traced):
    trace, _, _ = traced
    names = {s.name for s in trace.spans}
    assert names == set(PARENTS)
    for s in trace.spans:
        parent = None if s.parent < 0 else trace.spans[s.parent].name
        assert parent in PARENTS[s.name], (s.name, parent)
        assert s.end_ns is not None and s.end_ns >= s.start_ns
        if s.parent >= 0:
            p = trace.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    assert all(ns >= 0 for ns in trace.self_ns())


def test_one_request_id_a_frame(traced):
    trace, _, _ = traced
    roots = [(i, s) for i, s in enumerate(trace.spans) if s.parent < 0]
    assert [s.name for _, s in roots] == ["build", "frame", "build", "step",
                                          "step"]
    assert [s.frame for _, s in roots] == [1, 2, 3, 4, 5]
    root_of = {}
    for i, s in enumerate(trace.spans):
        root_of[i] = i if s.parent < 0 else root_of[s.parent]
        assert s.frame == trace.spans[root_of[i]].frame


def test_two_mesh_casts_a_depth_step(traced):
    trace, _, _ = traced
    depths = [i for i, s in enumerate(trace.spans) if s.name == "depth"]
    assert len(depths) == 3 * SMALL["max_depth"]
    for i in depths:
        kids = [s.name for s in trace.spans if s.parent == i]
        assert kids.count("cast.closest") == 1
        assert kids.count("cast.shadow") == 1
        assert trace.spans[i].attr in range(SMALL["max_depth"])


def test_ladder_counters_match_the_tier_wrapper(traced):
    trace, waits, counts = traced
    casts = ladder_casts(trace)
    c = trace.counters
    taken = [C for _, C, _ in waits]
    assert len(casts) == len(waits) == c["ladder.casts"] > 0
    assert [e["C"] for e in casts] == taken
    assert [e["n"] for e in casts] == counts
    assert c["ladder.compacted"] == sum(1 for C in taken if C) > 0
    assert c["ladder.capacity"] == sum(taken)
    assert c["ladder.active"] == sum(n for n, C in zip(counts, taken) if C)
    assert all(e["n"] <= e["C"] for e in casts if e["C"])
    assert c["ladder.wait_ns"] == sum(
        s.end_ns - s.start_ns for s in trace.spans if s.name == "ladder.wait")
    assert all(e["depth"] >= 1 and e["query"] in ("closest", "shadow")
               for e in casts)


def test_tier_log_reads_the_record_of_an_outer_trace():
    """TierLog inside a traced block shares its record and logs only the
    casts of its own block."""
    r = Renderer("array_bvh", device="cpu", **SMALL)
    with profiling.tracing():
        r.render_hdr(seed=0)
        with TierLog() as log:
            r.render_hdr(seed=0)
        n = profiling.collect().counters["ladder.casts"]
    assert len(log.log) * 2 == n
    assert profiling.collect().counters["ladder.casts"] == n


def test_the_clock_pairs_put_a_profiler_event_in_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing():
            for k in range(3):
                with profiling.span("outer", k):
                    time.sleep(0.002)
                    with record_function(f"inner{k}"):
                        time.sleep(0.001)
                    time.sleep(0.002)
    trace = profiling.collect()
    spans = [s for s in trace.spans if s.name == "outer"]
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("inner")}
    assert len(trace.clocks) >= 2
    for s in spans:
        e = events[f"inner{s.attr}"]
        t0 = trace.from_profiler_ns(e.start_ns())
        t1 = trace.from_profiler_ns(e.start_ns() + e.duration_ns())
        assert s.start_ns < t0 < t1 < s.end_ns
        assert abs(trace.to_profiler_ns(t0) - e.start_ns()) <= 1


def test_tracing_follows_a_profiler_session():
    r = Renderer("array_bvh", device="cpu", width=8, height=8, spp=1,
                 max_depth=1)
    with profile(activities=[ProfilerActivity.CPU]):
        r.render_hdr(seed=0)
        assert profiling.span("x") is not profiling.span("y")
        r.render_hdr(seed=1)
    assert profiling.span("x") is not profiling.span("y")
    r.render_hdr(seed=2)  # the first request after the session
    assert profiling.span("x") is profiling.span("y")
    trace = profiling.collect()
    assert [s.name for s in trace.spans if s.parent < 0] == ["frame",
                                                             "frame"]
    assert len(trace.clocks) == 2


def test_device_trace_writes_the_spans(tmp_path):
    r = Renderer("array_bvh", device="cpu", width=8, height=8, spp=1,
                 max_depth=1)
    with profiling.device_trace(str(tmp_path)):
        r.render_hdr(seed=0)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    frame = next(e for e in spans if e["name"] == "frame")
    assert {e["name"] for e in spans} >= {"frame", "render", "trace",
                                          "depth", "cast.closest"}
    inside = [e for e in ops
              if frame["ts"] <= e["ts"] <= frame["ts"] + frame["dur"]]
    assert len(inside) > 0.9 * len(ops)


def test_launch_wrappers_count_their_host_time():
    O = u = (torch.zeros(4),) * 3
    members = (torch.zeros((1, 8)), torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError):  # a CPU tensor: checked, not launched
        _kernels.pair_bits(O, u, 1, 4, members)
    with profiling.tracing():
        for _ in range(2):
            with pytest.raises(ValueError):
                _kernels.pair_bits(O, u, 1, 4, members)
    c = profiling.collect().counters
    assert c["launch.pair_bits.calls"] == 2 and c["launch.pair_bits.ns"] > 0
    assert _kernels.pair_bits.__name__ == "pair_bits"


def test_run_loop_times_every_display_arrival(monkeypatch):
    """Intervals from one arrival to the next, the first from the loop's
    start, writes left out: clock reads 0 (start), then 10 (frame 0
    arrives; pipelined, after frame 1 was enqueued), 10 (its writes done),
    11, 11, 13, 13."""
    r = Renderer("realtime", device="cpu", width=8, height=8, spp=1,
                 max_depth=1)
    clock = iter([0.0, 10.0, 10.0, 11.0, 11.0, 13.0, 13.0])
    monkeypatch.setattr(rt, "time", types.SimpleNamespace(
        perf_counter=lambda: next(clock)))
    _, summary = rt.run_loop(r.scene, r.cfg, 3, raw_pipe=io.BytesIO(),
                             print_every=0)
    assert summary["frames"] == 3
    assert summary["first_frame_ms"] == pytest.approx(10e3)
    assert summary["mean_ms"] == pytest.approx(13e3 / 3)
    assert summary["fps"] == pytest.approx(3 / 13)
    assert summary["p95_ms"] == pytest.approx(
        np.percentile([10e3, 1e3, 2e3], 95))
