"""The check can fail: at a size the CPU renders, the control (the
reference in bfloat16 put in the program's place) and every fault a cell
can have, planted in the timed path underneath a whole run, come out not
correct under the cell's own limits, while the same run unbroken comes
out correct.  The faults (``faults.py``) are global (half the samples,
every path's radiance, the loop's state, the display) or touch only what
the cat makes (its shadow cast, its smooth normals, a tenth of its
triangles).  (On the card the control and the faults are read at the
cells' own size by ``python3 -m benchmark.calibrate``.)

A run here sees only the loop's first frames, whose light sits in front
of the cat, so that its shadow falls behind it, out of a small frame's
view (the camera's reference quirk adds its position into every ray, and
at 48 pixels that turns the view).  The cell's window takes the light
round its orbit, 314 frames a turn; here the light moves 1.6 rad a frame,
so that the frames checked see the cat's shadow."""
from __future__ import annotations

import time

import numpy as np
import pytest

from benchmark import check, drivers, faults, meshes, run, spec

CELLS = ("array_bvh.spp32_d5", "realtime.loop_spp20_d3")
SEED = 2**31 + 1234
# frame and traffic of a run here, by the cell's driver: the cells' own
# depths, fewer samples, one frame of warm-up
SIZES = {"frames": ({"width": 64, "height": 64},
                    dict(spp=8, max_depth=5, warmup_frames=1)),
         "realtime": ({"width": 48, "height": 48},
                      dict(spp=8, max_depth=3, warmup_frames=1,
                           light_speed=80.0))}


def small(name):
    """The cell at a size the CPU renders, and its frame's settings."""
    cell = spec.load_cell(name)
    settings, traffic = SIZES[cell.traffic["driver"]]
    cell.traffic = dict(cell.traffic, **traffic)
    return cell, settings


def execute(name):
    cell, settings = small(name)
    res = run.execute(cell, SEED, 0.3, False, device="cpu",
                      settings=settings, t_start=time.perf_counter())
    return res["correct"], {k: v["value"] for k, v in res["checked"].items()}


CASES = [(c, f) for c in CELLS for f in faults.FAULTS
         if faults.applies(f, spec.load_cell(c))]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    ok, nums = execute(name)
    assert ok, nums


@pytest.mark.parametrize("name,fault", CASES)
def test_fault_is_not_correct(name, fault):
    undo = faults.plant(fault)
    try:
        ok, nums = execute(name)
    finally:
        for u in undo:
            u()
    assert not ok, nums


def test_every_mesh_fault_is_planted_where_the_cell_has_it():
    """Both cells have the cat's shadow cast and triangles; only the loop
    shades it with smooth normals."""
    want = {"shadow_ignores_mesh": set(CELLS), "tenth_dropped": set(CELLS),
            "flat_normals": {CELLS[1]}}
    assert set(faults.MESH_FAULTS) == set(want)
    for f in faults.MESH_FAULTS:
        assert {c for c, g in CASES if g == f} == want[f]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell, settings = small(name)
    chk = check.load(name)
    mesh = meshes.resolve(cell.config)
    drv = drivers.make(cell, SEED, "cpu", mesh, settings, chk["frames"])
    drv.build()
    drv.window(0.2, drv.warm())
    items = drv.checked()
    sound = check.compare(cell, items, mesh.path, "cpu", chk["rows"],
                          settings)
    low = check.control(cell, items, mesh.path, "cpu", chk["rows"],
                        settings)
    assert check.verdict(sound, chk["limits"]), sound
    assert not check.verdict(low, chk["limits"]), low
    assert low["px_off_share"] > 3 * sound["px_off_share"]
    assert np.isfinite(list(low.values())).all()
