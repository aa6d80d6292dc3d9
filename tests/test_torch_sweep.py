"""The port's benchmark sweep against the JAX package's
(raytracinggpu_tpu_torch/bench/sweep.py against
raytracinggpu_tpu/bench/sweep.py): the same arguments give the same
result keys, the same printed lines (numbers apart) and the same JSON
file layout, on the ``cpu`` preset at 16x16, two cells."""
import contextlib
import inspect
import io
import json
import re

import numpy as np
import pytest
import torch

from raytracinggpu_tpu.bench.sweep import run_sweep as j_run_sweep
from raytracinggpu_tpu_torch.bench.sweep import run_sweep

torch.set_num_threads(2)

ARGS = dict(preset="cpu", width=16, height=16, spps=(1, 2), bounces=(1,),
            repeats=2)
NUMBER = re.compile(r"\d+\.\d+")


@pytest.fixture(scope="module")
def sweeps(tmp_path_factory):
    """((results, printed lines, JSON file) of the port, of the JAX
    package), both through the default traversal."""
    d = tmp_path_factory.mktemp("sweep")
    out = []
    for name, fn, extra in (("port", run_sweep, {"device": "cpu"}),
                            ("jax", j_run_sweep, {})):
        path = str(d / f"{name}.json")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = fn(out=path, **ARGS, **extra)
        with open(path) as f:
            out.append((res, buf.getvalue().splitlines(), json.load(f)))
    return out


def test_same_arguments_and_defaults():
    j = inspect.signature(j_run_sweep).parameters
    p = inspect.signature(run_sweep).parameters
    assert list(p)[:len(j)] == list(j)
    for name in j:
        assert p[name].default == j[name].default, name
    assert list(p)[len(j):] == ["device"]  # the port's one addition


def test_same_result_keys(sweeps):
    (port, _, _), (jax_, _, _) = sweeps
    assert list(port) == list(jax_) == [(1, 1), (2, 1)]
    for cell in port:
        assert list(port[cell]) == list(jax_[cell]) == ["first_s", "steady_s",
                                                        "mrays"]
        r = port[cell]
        assert r["first_s"] > 0 and r["steady_s"] > 0
        rays = 16 * 16 * cell[0] * (2 * cell[1] + 1)
        assert r["mrays"] == pytest.approx(rays / r["steady_s"] / 1e6)


def test_same_printed_lines(sweeps):
    (_, port, _), (_, jax_, _) = sweeps
    shape = lambda lines: [NUMBER.sub("#", ln.rsplit("wrote ", 1)[0])
                           for ln in lines]
    assert shape(port) == shape(jax_)
    assert port[0].startswith("spp=   1 bounces= 1: ")
    assert port[2] == "\truntime matrix (s): rows=spp, cols=bounces"
    assert re.fullmatch(r"   1: \d+\.\d{3}", port[3])
    assert port[-1].startswith("wrote ")


def test_same_json_file(sweeps):
    (res, _, port), (_, _, jax_) = sweeps
    assert list(port) == list(jax_) == ["1x1", "2x1"]
    assert port["2x1"] == res[(2, 1)]
    assert list(port["1x1"]) == list(jax_["1x1"])


def test_skip_and_on_cell(capsys):
    seen = []
    res = run_sweep(preset="showcase", width=8, height=8, spps=(1, 2),
                    bounces=(1, 2), repeats=1, traversal="pairs",
                    skip=lambda s, b: s == 2 and b == 2,
                    on_cell=lambda s, b, r: seen.append((s, b, r["mrays"])),
                    device="cpu")
    assert sorted(res) == [(1, 1), (1, 2), (2, 1)]
    assert [c[:2] for c in seen] == [(1, 1), (2, 1), (1, 2)]
    assert all(np.isfinite(c[2]) and c[2] > 0 for c in seen)
    lines = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"   2: \d+\.\d{3} -", lines[-1])  # the skipped cell


def test_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(preset="showcase", width=8, height=8, spps=(1,),
                  bounces=(1,))
