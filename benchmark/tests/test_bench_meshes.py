"""The mesh of a configuration comes from one resolver (``meshes.py``):
the two cells' cat goes down the preset's own path, and a configuration
that names an OBJ file of its own gives that file to the program, through
``obj_path``, and to the reference alike.

A cell made here (not one of ``BENCHMARK.json``'s) names a copy of the
cat as its own OBJ, built with the LBVH builder, at the size and under
the limits that ``test_bench_faults.py`` runs the array scene's cell: it
runs through ``run.execute`` on the CPU and comes out correct, while the
program given the mesh one unit higher than the reference's, or a mesh
fault planted under it, comes out not correct."""
from __future__ import annotations

import copy
import shutil
import time

import pytest

from benchmark import check, drivers, faults, meshes, run, spec

SEED = 2**31 + 1234
CELLS = ("array_bvh.spp32_d5", "realtime.loop_spp20_d3")
BASE = CELLS[0]
CAT = {"obj": "cat", "scale": 0.6, "offset": [0.0, -10.0, 0.0]}


@pytest.fixture
def objs(tmp_path, monkeypatch):
    """The committed OBJ files: one copy of the cat, ``custom_cat``."""
    shutil.copy(meshes.cat_path(), tmp_path / "custom_cat.obj")
    monkeypatch.setattr(meshes, "OBJ_DIR", str(tmp_path))
    return tmp_path


def custom_cell():
    """The array scene with its cat read as a custom OBJ, LBVH, at 64 x 64,
    8 samples, the cell's depth 5."""
    base = spec.load_cell(BASE)
    config = copy.deepcopy(base.config)
    config["name"] = "custom_cat"
    config["program"]["settings"] = {"width": 64, "height": 64,
                                     "bvh_builder": "lbvh"}
    config["view"] = dict(config["view"], width=64, height=64)
    config["scene"]["mesh"] = dict(config["scene"]["mesh"], obj="custom_cat")
    return spec.Cell(name="custom_cat.spp8_d5", chips=1, config=config,
                     traffic=dict(base.traffic, spp=8, warmup_frames=1),
                     end_to_end=base.end_to_end, per_layer=base.per_layer)


def execute(cell, monkeypatch):
    """A run of ``cell`` under the array scene's check."""
    chk = check.load(BASE)
    monkeypatch.setattr(check, "load", lambda name: chk)
    res = run.execute(cell, SEED, 0.3, False, device="cpu",
                      t_start=time.perf_counter())
    return res, {k: v["value"] for k, v in res["checked"].items()}


@pytest.mark.parametrize("entry,words", [
    (dict(CAT, obj="dog"), ["'dog'", "'cat'", "'custom_cat'"]),
    (dict(CAT, obj="../configs/array_bvh"), ["'cat'", "'custom_cat'"]),
    ({"scale": 1.0, "offset": [0.0, 0.0, 0.0]}, ["'obj'"]),
    (dict(CAT, colour=1), ["'colour'", "'smooth_normals'"]),
])
def test_unknown_mesh_names_the_choices(entry, words, objs):
    with pytest.raises(ValueError) as e:
        meshes.resolve({"scene": {"mesh": entry}})
    for w in words:
        assert w in str(e.value)


@pytest.mark.parametrize("name", CELLS + ("custom",))
def test_program_gets_the_resolved_mesh(name, objs, monkeypatch):
    """The two cells' cat goes down the preset's own load, with no
    ``obj_path``; a named OBJ through ``obj_path`` with the entry's scale
    and offset, the file the reference reads."""
    import raytracinggpu_tpu_torch

    cell = custom_cell() if name == "custom" else spec.load_cell(name)
    mesh = meshes.resolve(cell.config)
    seen = {}
    monkeypatch.setattr(raytracinggpu_tpu_torch, "Renderer",
                        lambda preset, **k: seen.update(k, preset=preset))
    drivers.Driver(cell, 1, "cpu", mesh).build()
    assert seen["preset"] == cell.config["program"]["preset"]
    if name == "custom":
        assert seen["obj_path"] == str(objs / "custom_cat.obj")
        assert seen["obj_scale"] == 0.6
        assert seen["obj_offset"] == (0.0, -10.0, 0.0)
        assert seen["bvh_builder"] == "lbvh"
    else:
        assert mesh.preset_own and mesh.path == meshes.cat_path()
        assert not {"obj_path", "obj_scale", "obj_offset"} & set(seen)


def test_custom_mesh_cell_is_correct(objs, monkeypatch):
    res, nums = execute(custom_cell(), monkeypatch)
    assert res["correct"], nums


def test_custom_mesh_elsewhere_is_not_correct(objs, monkeypatch):
    """The program renders the mesh one unit higher than the reference,
    which places it where the configuration says."""
    make = drivers.make

    def higher(cell, seed, device, mesh, *a, **k):
        up = meshes.Mesh(mesh.path, mesh.scale, (0.0, -9.0, 0.0), False)
        return make(cell, seed, device, up, *a, **k)

    monkeypatch.setattr(drivers, "make", higher)
    res, nums = execute(custom_cell(), monkeypatch)
    assert not res["correct"], nums


def test_custom_cell_has_the_mesh_faults_and_no_loop_fault():
    assert {f for f in faults.FAULTS if faults.applies(f, custom_cell())} \
        == {"half_the_samples", "altered_paths", "shadow_ignores_mesh",
            "tenth_dropped"}


@pytest.mark.parametrize("fault", ["tenth_dropped", "shadow_ignores_mesh"])
def test_mesh_fault_reaches_the_custom_mesh(fault, objs, monkeypatch):
    """Each fault fails the check by a wide margin, not by a pixel."""
    undo = faults.plant(fault)
    try:
        res, nums = execute(custom_cell(), monkeypatch)
    finally:
        for u in undo:
            u()
    assert not res["correct"], nums
    limits = check.load(BASE)["limits"]
    assert max(nums[k] / limits[k] for k in limits) > 2, nums
