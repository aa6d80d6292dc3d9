"""The benchmark's custom-mesh deployment: dm_control's dog skeleton
(``benchmark/objs/dog_skeleton.obj``, 308,472 triangles) in the array
scene, built with LBVH through ``Renderer(obj_path=...)``.

- the committed OBJ is the skeleton as recorded, and its script writes
  it again byte for byte from the installed dm_control (or, without it,
  says so and exits 1);
- the configuration gives the program ``obj_path`` and ``bvh_builder``
  ``lbvh``, and its build takes the branches of a large mesh: subgroup
  16, a ladder key over unions of 32 tiles (89 boxes of 2,834 tiles),
  casts of up to 2^24 lanes by the key;
- a whole ``benchmark.run.execute`` of the cell on the CPU, every
  triangle at a 16 x 16 frame of 1 sample and depth 1, is correct under
  the cell's own limits, and not correct with a mesh fault planted (the
  shadow's fault, planted at render time, renders with the sound run's
  Renderer: one LBVH build fewer);
- the build's spans and counters are in ``profiling.collect().build``
  after a build with tracing off, ``bvh_build_s`` reads the BVH's span
  there, and the run's frames add nothing to either record;
- keyed on its 2,834 tile boxes, a small frame is bitwise the same in
  one cast whose ladder key takes mode 1 and in casts of one sample,
  narrow enough for mode 2.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import raytracinggpu_tpu_torch
from benchmark import check, faults, meshes, run, spec
from raytracinggpu_tpu_torch.ops.pairs_trace import _key_mode, key_lanes
from raytracinggpu_tpu_torch.render.pipeline import (
    CAST_CAP,
    render_preset_frame,
)
from raytracinggpu_tpu_torch.scene.obj import read_obj
from raytracinggpu_tpu_torch.utils import profiling

CELL = "dog_skeleton.spp4_d2"
OBJ = os.path.join(meshes.OBJ_DIR, "dog_skeleton.obj")
SCRIPT = os.path.join(meshes.OBJ_DIR, "dog_skeleton_from_dm_control.py")
SHA256 = "fd151fd292b518c7feca6d6207a4c90955515ab132dc2811bb4adec95af64e12"
N_FACES, N_VERTS = 308_472, 152_930
# the OBJ's bounds, y-up, as its text gives them
LO = np.float32(["-0.726581", "0.00333692", "-0.105795"])
HI = np.float32(["0.444871", "0.739873", "0.105795"])
SEED = 2**31 + 1234
# a frame the CPU renders in seconds; blocks of 128 rays
SETTINGS = {"width": 16, "height": 16, "pairs_block": 128}
TRAFFIC = {"spp": 1, "max_depth": 1, "warmup_frames": 0}

torch.set_num_threads(2)


def small_cell():
    cell = spec.load_cell(CELL)
    cell.traffic = dict(cell.traffic, **TRAFFIC)
    return cell


def execute(renderer=None):
    """A whole run of the cell at the small size (with ``renderer`` in
    place of its build, where given); its result line and the numbers
    compared."""
    with pytest.MonkeyPatch.context() as mp:
        if renderer is not None:
            mp.setattr(raytracinggpu_tpu_torch, "Renderer",
                       lambda preset, **kw: renderer)
        res = run.execute(small_cell(), SEED, 0.01, False, device="cpu",
                          settings=SETTINGS, t_start=time.perf_counter())
    return res, {k: v["value"] for k, v in res["checked"].items()}


@pytest.fixture(scope="module")
def sound():
    """The sound run, with the Renderer it built and the keywords it was
    built with, and the records of the tracer before and after it."""
    made = []
    real = raytracinggpu_tpu_torch.Renderer

    def recording(preset, **kw):
        made.append((preset, kw, real(preset, **kw)))
        return made[-1][2]

    before = profiling.collect()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(raytracinggpu_tpu_torch, "Renderer", recording)
        res, nums = execute()
    assert len(made) == 1
    return {"res": res, "nums": nums, "made": made[0], "before": before,
            "after": profiling.collect(), "t_end": time.perf_counter()}


def test_committed_obj_is_the_skeleton():
    with open(OBJ, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == SHA256
    obj = read_obj(OBJ)
    assert obj.vtx.shape == (N_FACES, 3)
    assert obj.vertices.shape == (N_VERTS, 3)
    assert obj.normals.shape[0] == 0 and obj.uvs.shape[0] == 0
    assert (obj.vertices.min(0) == LO).all()
    assert (obj.vertices.max(0) == HI).all()
    v = obj.vtx
    assert (v[:, 0] != v[:, 1]).all() and (v[:, 1] != v[:, 2]).all() \
        and (v[:, 0] != v[:, 2]).all()
    a, b, c = (obj.vertices[v[:, k]].astype(np.float64) for k in range(3))
    assert (np.linalg.norm(np.cross(b - a, c - a), axis=1) > 0).all()


def test_script_writes_the_obj_again(tmp_path):
    """Byte for byte from the installed dm_control; where it is not
    installed, the script says so and exits 1."""
    out = tmp_path / "dog.obj"
    p = subprocess.run([sys.executable, SCRIPT, "--out", str(out)],
                       capture_output=True, text=True, timeout=300)
    if importlib.util.find_spec("dm_control") is None:
        assert p.returncode == 1 and "dm_control" in p.stderr
        assert not out.exists()
        return
    assert p.returncode == 0, p.stderr
    with open(OBJ, "rb") as f:
        assert out.read_bytes() == f.read()


def test_configuration_takes_the_large_mesh_path(sound):
    preset, kw, r = sound["made"]
    assert preset == "array_bvh"
    assert kw["obj_path"] == OBJ and kw["bvh_builder"] == "lbvh"
    assert kw["obj_scale"] == 32.0 and kw["obj_offset"] == (4.5, -10.0, 0.0)
    tab = r.scene.pairs_mesh
    nc = int(tab.tile_aabb.shape[0])
    assert (nc, int(tab.member_aabb.shape[0])) == (2834, 4394)
    assert r.cfg.pairs_subgroup == 16 and r.cfg.pairs_key_coarse == 32
    assert key_lanes(nc, r.cfg.pairs_key_coarse) == 2**24 > CAST_CAP
    assert r.scene.mesh.n_tri == N_FACES


def test_sound_run_is_correct(sound):
    assert sound["res"]["correct"], sound["nums"]
    assert sound["res"]["attempted"] >= 1


@pytest.mark.parametrize("fault", ["tenth_dropped", "shadow_ignores_mesh"])
def test_mesh_fault_is_not_correct(fault, sound):
    assert faults.applies(fault, small_cell())
    # the OBJ's fault needs a build of its own
    renderer = None if fault == "tenth_dropped" else sound["made"][2]
    undo = faults.plant(fault)
    try:
        res, nums = execute(renderer)
    finally:
        for u in undo:
            u()
    assert not res["correct"], nums
    limits = check.load(CELL)["limits"]
    assert max(nums[k] / limits[k] for k in limits) > 2, nums


def test_build_spans_and_counters_kept_with_tracing_off(sound):
    """One build's spans and counters in the build record, where
    ``bvh_build_s`` reads the BVH's span; tracing's own record as it was,
    though the run rendered and checked frames."""
    before, after = sound["before"], sound["after"]
    n = 0 if before is None else len(before.build.spans)
    new = after.build.spans[n:]
    assert [s.name for s in new] == [
        "build", "build.mesh", "build.obj", "build.bvh", "build.tables",
        "build.upload"]
    bvh = new[3]
    assert bvh.attr == N_FACES and bvh.end_ns > bvh.start_ns
    read = spec.reader("bvh_build_s")
    assert read(SimpleNamespace(t0=sound["t_end"])) == \
        (bvh.end_ns - bvh.start_ns) * 1e-9
    assert all(s.frame == new[0].frame for s in new)
    old = {} if before is None else before.build.counters
    grown = {k: v - old.get(k, 0) for k, v in after.build.counters.items()}
    assert grown == {"mesh.triangles": N_FACES, "pairs.tiles": 2834,
                     "pairs.members": 4394, "ladder.key_boxes": 89}
    window = lambda t: ([], {}) if t is None else (t.spans, t.counters)
    assert window(after) == window(before)


# name: (config fields, (wavefronts, samples, compacted casts keyed in
# mode 1: all or none))
KEY_MODE_RUNS = {
    "one 512-lane cast, mode 1": ({}, (1, 2, True)),
    "a 256-lane cast a sample, mode 2": ({"spp_fuse": 1}, (2, 2, False))}


def test_frame_does_not_depend_on_the_key_mode(sound):
    """A 16 x 16 frame of 2 samples, depth 2, its ladder keyed on the 2,834
    tile boxes (``pairs_key_coarse`` 1: mode 2 holds 256 lanes, mode 1
    2^19): both samples in one 512-lane cast, whose key takes mode 1 (the
    default grouping, spp_fuse unset), and one sample a wavefront
    (spp_fuse 1), each in one 256-lane cast keyed in mode 2, bitwise the
    same frame and stats; both runs compact casts, and the tracer's
    counters say how many wavefronts of how many samples ran and how many
    compacted casts keyed in mode 1."""
    _, _, r = sound["made"]
    base = dataclasses.replace(r.cfg, spp=2, max_depth=2, pairs_key_coarse=1)
    nc = int(r.scene.pairs_mesh.tile_aabb.shape[0])
    assert base.pairs_block == 128 and base.spp_fuse is None
    assert _key_mode(nc, 256) == (2, 8) and _key_mode(nc, 512) == (1, 19)
    frames = []
    for over, (n_wave, n_samples, mode1) in KEY_MODE_RUNS.values():
        with profiling.tracing():
            img, stats = render_preset_frame(
                r.scene, dataclasses.replace(base, **over), seed=SEED)
        c = profiling.collect().counters
        assert (c["wavefront.count"], c["wavefront.samples"]) == (
            n_wave, n_samples)
        assert c["ladder.compacted"] > 0
        assert c["ladder.key_mode1"] == (c["ladder.compacted"] if mode1
                                         else 0)
        frames.append((img, *stats))
    for other in frames[1:]:
        for a, b in zip(frames[0], other):
            np.testing.assert_array_equal(a, b)
