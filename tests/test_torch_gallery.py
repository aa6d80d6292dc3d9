"""The port's gallery (raytracinggpu_tpu_torch/bench/gallery.py) on the CPU
at 16x16: one frame row, one realtime row, one interactive row and ported
ablation rows through ``main``, the files it writes, its exit code when a
row fails, and its modes against the JAX package's.

The JAX package's modes are read from its source with ``ast``: importing
``raytracinggpu_tpu.bench.gallery`` would call its ``setup_cache()`` and
set JAX's cache directory for this worker (ROADMAP C3).
"""
import ast
import dataclasses
import json
import os

import pytest
import torch

from raytracinggpu_tpu_torch.bench import gallery
from raytracinggpu_tpu_torch.scene.scene import RenderConfig

torch.set_num_threads(2)

JAX_GALLERY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "raytracinggpu_tpu", "bench", "gallery.py")
SMALL = (16, 16)


def _jax_modes() -> dict:
    with open(JAX_GALLERY) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if (isinstance(node, ast.Assign)
                and node.targets[0].id == "ABLATION_MODES"):
            return ast.literal_eval(node.value)
    raise AssertionError("no ABLATION_MODES in the JAX gallery")


@pytest.fixture()
def small(monkeypatch):
    """Every row at 16x16 (the bvh rows' reduced size too)."""
    w, h = SMALL
    monkeypatch.setattr(gallery, "FRAME_CASES", tuple(
        (n, p, w, h) for n, p, *_ in gallery.FRAME_CASES))
    monkeypatch.setattr(gallery, "REALTIME_CASES", tuple(
        (n, w, h, s, d) for n, _, _, s, d in gallery.REALTIME_CASES))
    monkeypatch.setattr(gallery, "INTERACTIVE_CASES", tuple(
        (n, w, h, s, d) for n, _, _, s, d in gallery.INTERACTIVE_CASES))
    monkeypatch.setattr(gallery, "PROTOCOL", (w, h, 4, 2))
    monkeypatch.setattr(gallery, "ABLATION_MODES", {
        k: ({**v, "_size": (w, h, 2, 2)} if "_size" in v else v)
        for k, v in gallery.ABLATION_MODES.items()})


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_rows_and_files_on_the_cpu(small, tmp_path, capsys):
    rc = gallery.main([
        "--device", "cpu", "--quick", "--out", str(tmp_path),
        "--only", "frames,realtime,interactive,ablations",
        "--rows", "showcase,progressive_800x600_spp1_d1",
        "--ablation-rows", "pallas_tiled_s64"])
    assert rc == 0
    assert sorted(os.listdir(tmp_path)) == ["torch_ablations.json",
                                            "torch_results.json"]
    res = _load(tmp_path / "torch_results.json")
    abl = _load(tmp_path / "torch_ablations.json")
    for doc in (res, abl):
        assert doc["device"] == "cpu" and doc["card"] is None
        assert doc["torch"] == torch.__version__
        assert "cuda" in doc
    rows = res["rows"]
    assert list(rows) == ["showcase", "progressive_800x600_spp1_d1"]
    frame = rows["showcase"]
    assert (frame["width"], frame["spp"], frame["depth"]) == (16, 4, 5)
    assert frame["frame_s"] > 0 and frame["mrays"] > 0
    rt = rows["progressive_800x600_spp1_d1"]
    assert (rt["width"], rt["spp"], rt["depth"]) == (16, 1, 1)
    assert rt["frames"] == 4 and rt["ms_per_frame"] > 0
    assert list(abl["rows"]) == ["pallas_tiled_s64"]
    assert abl["rows"]["pallas_tiled_s64"]["overrides"] == {
        "traversal": "pallas"}
    out = capsys.readouterr().out
    assert "dropped JAX modes:" in out and "pairs_wordmajor" in out


def test_interactive_row_takes_the_wall_time(monkeypatch):
    monkeypatch.setattr(gallery, "INTERACTIVE_CASES",
                        (("loop", *SMALL, 1, 1),))
    loop = gallery.interactive_rows("cpu", quick=True)["loop"]
    assert loop["frames"] == 6 and loop["ms_per_frame"] > 0
    assert loop["run_loop_mean_ms"] > 0 and "mean_ms" in loop["note"]


def test_a_failing_row_makes_main_exit_1(small, tmp_path, monkeypatch):
    monkeypatch.setitem(gallery.ABLATION_MODES, "broken",
                        {"traversal": "tiles"})
    rc = gallery.main(["--device", "cpu", "--quick", "--out", str(tmp_path),
                       "--only", "ablations",
                       "--ablation-rows", "dense,broken"])
    assert rc == 1
    rows = _load(tmp_path / "torch_ablations.json")["rows"]
    assert "error" in rows["broken"] and "tiles" in rows["broken"]["error"]
    assert "error" not in rows["dense"]
    assert gallery.main(["--device", "cpu", "--quick",
                         "--ablation-row", "broken"]) == 1


def test_one_ablation_row_prints_its_json(small, capsys):
    assert gallery.main(["--device", "cpu", "--quick",
                         "--ablation-row", "bvh_skiplinks"]) == 0
    row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert row["overrides"] == {"traversal": "bvh"} and row["frame_s"] > 0
    assert (row["spp"], row["depth"]) == (2, 2) and "note" in row


def test_ported_modes_are_render_config_fields():
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    for name, mode in gallery.ABLATION_MODES.items():
        over = {k: v for k, v in mode.items() if not k.startswith("_")}
        assert set(over) <= fields, name
        dataclasses.replace(RenderConfig(), **over)  # values it accepts


def test_modes_cover_the_jax_gallery():
    """Every JAX mode is ported (under its own name or its RENAMED one,
    with the same overrides) or dropped with a reason that names the knob
    it sets; no port mode lacks a JAX counterpart."""
    jax_modes = _jax_modes()
    assert not set(gallery.DROPPED) & set(gallery.RENAMED)
    ported = set()
    for name, mode in jax_modes.items():
        if name in gallery.DROPPED:
            why = gallery.DROPPED[name]
            knobs = [k for k in mode if not k.startswith("_")]
            assert why and any(k.split("_")[0] in why or k in why
                               for k in knobs), name
            continue
        port = gallery.RENAMED.get(name, name)
        assert port in gallery.ABLATION_MODES, name
        strip = lambda m: {k: v for k, v in m.items()
                           if not k.startswith("_")}
        assert strip(gallery.ABLATION_MODES[port]) == strip(mode), name
        assert gallery.ABLATION_MODES[port].get("_size") == mode.get("_size")
        ported.add(port)
    assert ported == set(gallery.ABLATION_MODES)


def test_no_dropped_mode_sets_only_ported_knobs():
    """A mode is dropped only for a knob the port has no field for."""
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    jax_modes = _jax_modes()
    for name in gallery.DROPPED:
        knobs = {k for k in jax_modes[name] if not k.startswith("_")}
        assert knobs - fields, name
