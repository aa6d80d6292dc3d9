"""The harness resolves cells, configurations, traffic, checks and
metrics by name, ``BENCHMARK.json`` keeps to the benchmark's contract, and
a run's last line has the shape the driver reads (a small frame on the
CPU; the card's run is the ``cuda`` case)."""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from benchmark import check, run, spec

ROOT = spec.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = {"width": 24, "height": 24}


def small(cell):
    """The cell at a size the CPU renders in seconds."""
    cell.traffic = dict(cell.traffic, spp=2, max_depth=2)
    return cell


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_every_file_by_name(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert cell.traffic["driver"] in ("frames", "realtime")
    assert set(check.load(name)["limits"]) >= {"px_off_share", "mean_gap"}
    reported = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"setup_s", "mrays_per_s"} <= reported
    for m in reported:
        assert callable(spec.reader(m))


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no_such.cell")


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("traced", [False, True])
def test_last_line_shape(name, traced):
    cell = small(spec.load_cell(name))
    res = run.execute(cell, 2**31 + 7, 0.5, traced, device="cpu",
                      settings=SMALL, t_start=time.perf_counter())
    assert list(res)[-1] == "checked"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["attempted"] >= 1 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    want = {m["name"] for m in cell.metrics(traced)}
    assert set(res["metrics"]) <= want
    if not traced:
        assert set(res["metrics"]) == want
    for v in res["metrics"].values():
        assert set(v) == {"value", "unit"}
    assert set(res["checked"]) == set(check.load(name)["limits"])
    for v in res["checked"].values():
        assert v["value"] is not None and v["limit"] is not None
    json.dumps(res)


def test_host_clock_readings_come_from_the_untraced_window(monkeypatch):
    """A traced run reads its per-layer host-clock metrics from a window
    of their own, outside the trace's spans; the rest from the traced
    window."""
    cell = small(spec.load_cell("realtime.loop_spp20_d3"))
    seen = {}
    read = spec.reader

    def reader(name):
        fn = read(name)

        def call(r):
            seen[name] = r.spans is None and r.frames > 0
            return fn(r)
        return call

    monkeypatch.setattr(spec, "reader", reader)
    res = run.execute(cell, 2**31 + 9, 0.5, True, device="cpu",
                      settings=SMALL, t_start=time.perf_counter())
    host = {m["name"] for m in cell.per_layer
            if m["source"] == "host_clock"}
    assert host and "frame_ms_p95.host_paced" in res["metrics"]
    assert {n for n, untraced in seen.items() if untraced} == host


def test_no_card_no_result():
    """Without the cards a cell asks for, the command exits nonzero and
    prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_card_run_is_correct(card, name):
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        name, "--seed", str(2**31 + 99), "--seconds", "3",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
