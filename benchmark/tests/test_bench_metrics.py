"""The metric arithmetic on synthetic inputs: the interval union and
idle gaps, the percentile over frames, the ray count, each reader on a
made-up run, and the breakdown's labels."""
from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from benchmark import frozen, spec, trace
from benchmark.run import Run


@pytest.mark.parametrize("spans,union", [
    ([], 0.0),
    ([(0, 1)], 1.0),
    ([(0, 2), (1, 3)], 3.0),
    ([(0, 1), (2, 3)], 2.0),
    ([(0, 10), (2, 3), (4, 5)], 10.0),
    ([(5, 6), (0, 1), (0.5, 2)], 3.0),
])
def test_interval_union(spans, union):
    assert frozen.interval_union(spans) == pytest.approx(union)


def test_idle_gaps():
    assert frozen.idle_gaps([(1, 2), (1.5, 3), (5, 6)], 0, 8) == [
        (0, 1), (3, 5), (6, 8)]
    assert frozen.idle_gaps([(0, 8)], 0, 8) == []


@pytest.mark.parametrize("w,h,spp,d,rays", [
    (512, 512, 32, 5, 92_274_688), (512, 512, 20, 3, 36_700_160),
    (512, 512, 256, 1, 201_326_592)])
def test_rays_per_frame(w, h, spp, d, rays):
    assert frozen.rays_per_frame(w, h, spp, d) == rays


def fake_run(arrivals, ops=None, tiers=(), casts=None, tests=None):
    cell = types.SimpleNamespace(
        traffic={"spp": 32, "max_depth": 5},
        config={"view": {"width": 512, "height": 512}})
    run = Run(cell, None)
    run.t0, run.arrivals = 0.0, list(arrivals)
    run.t_end = run.arrivals[-1]
    run.setup_s, run.host_build_s = 12.5, 0.25
    run.ops = ops
    run.mesh_tests_per_frame = tests
    if casts is not None:
        run.spans = types.SimpleNamespace(
            tiers=types.SimpleNamespace(log=list(tiers)), casts=casts)
    return run


def value(metric, run):
    return spec.reader(metric)(run)


def test_end_to_end_readers():
    run = fake_run([0.2, 0.4, 0.6, 0.8, 1.0])
    assert value("mrays_per_s", run) == pytest.approx(5 * 92_274_688 / 1e6)
    assert value("setup_s", run) == 12.5
    assert value("host_build_s", run) == 0.25
    # intervals 0.2 each but one long one: p95 of [0.1]*19 + [1.0]
    arr = np.cumsum([0.1] * 19 + [1.0])
    run = fake_run(arr)
    assert value("frame_ms_p95.host_paced", run) == pytest.approx(
        np.percentile([0.1] * 19 + [1.0], 95) * 1e3)


def test_device_readers():
    ops = [("void (anonymous namespace)::pairs_kernel<2>(float const*)",
            0.0, 0.3), ("pairs_kernel<0>", 0.2, 0.4),
           ("pairs_kernel<1>", 0.5, 0.6), ("Memcpy DtoH", 0.9, 1.0)]
    run = fake_run([0.5, 1.0], ops=ops, tests=1e9)
    assert run.busy_s == pytest.approx(0.6)
    assert value("device_idle_share", run) == pytest.approx(40.0)
    assert value("device_ms_per_frame", run) == pytest.approx(300.0)
    assert value("device_ops_per_frame", run) == 2.0
    # B1 + B2 only: 0.3 + 0.2 s over 2 frames
    assert value("mesh_query_ms_per_frame", run) == pytest.approx(250.0)
    least = 1e9 * 39 / 67e12
    assert value("mesh_query_roofline_pct", run) == pytest.approx(
        least / 0.25 * 100)


def test_readers_return_nothing_without_a_trace():
    run = fake_run([0.5, 1.0])
    for m in ("device_idle_share", "device_ms_per_frame",
              "device_ops_per_frame", "mesh_query_ms_per_frame",
              "mesh_query_roofline_pct", "ladder_wait_ms_per_frame",
              "ladder_compacted_share"):
        assert value(m, run) is None


def test_ladder_readers():
    tiers = [(1, 40960, 0.002), (1, 0, 0.001), (2, 69632, 0.003)]
    run = fake_run([0.5, 1.0], ops=[], tiers=tiers, casts={0: 4, 1: 2, 2: 2})
    assert value("ladder_wait_ms_per_frame", run) == pytest.approx(3.0)
    assert value("ladder_compacted_share", run) == pytest.approx(50.0)


def test_breakdown_labels_gaps_by_innermost_span():
    ops = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k1", 5.0, 6.0)]
    spans = [("frame", 0.0, 6.0), ("ladder_wait", 1.0, 2.5),
             ("readback", 3.5, 4.5)]
    b = trace.breakdown(ops, spans, 0.0, 7.0)
    assert b["device_ops"] == [["k1", 2.0], ["k2", 1.0]]
    assert dict(b["idle_gaps"]) == {"ladder_wait": 1.0, "readback": 2.0,
                                    "outside spans": 1.0}


def test_slab_enter_exit_matches_a_direct_count():
    g = torch.Generator().manual_seed(3)
    O = torch.rand(3, 500, generator=g) * 4 - 2
    u = torch.nn.functional.normalize(torch.randn(3, 500, generator=g), dim=0)
    lo = torch.rand(5, 3, generator=g) - 0.5
    box = torch.cat([lo, lo + 0.7, torch.zeros(5, 2)], 1)
    _, _, hit = frozen.slab_enter_exit(O, u, box)
    # march each ray in small steps and see whether it passes a box
    ts = torch.linspace(0, 8, 4001)
    P = O[:, None, :] + u[:, None, :] * ts[None, :, None]      # (3, T, R)
    inside = ((P[None] >= box[:, :3, None, None])
              & (P[None] <= box[:, 3:6, None, None])).all(1).any(1)
    assert (hit == inside).float().mean() > 0.99
