"""The benchmark's cell at upstream's grid point (256, 1),
``array_bvh.spp256_d1``: many samples of direct light a frame, every mesh
cast at full width (depth 1 has no cast at depth 1 or deeper, so the
compaction ladder never runs).  A whole ``benchmark.run.execute`` of the
cell on the CPU, at a 32 x 32 frame of 16 samples, is correct under the
cell's own limits, and not correct with any fault the cell can have
planted (``benchmark/faults.py``)."""
from __future__ import annotations

import time

import pytest
import torch

from benchmark import check, faults, run, spec

CELL = "array_bvh.spp256_d1"
SEED = 2**31 + 1234
SETTINGS = {"width": 32, "height": 32}
TRAFFIC = {"spp": 16, "warmup_frames": 1}

torch.set_num_threads(2)


def small_cell():
    cell = spec.load_cell(CELL)
    assert cell.traffic["max_depth"] == 1
    cell.traffic = dict(cell.traffic, **TRAFFIC)
    return cell


def execute():
    res = run.execute(small_cell(), SEED, 0.01, False, device="cpu",
                      settings=SETTINGS, t_start=time.perf_counter())
    return res, {k: v["value"] for k, v in res["checked"].items()}


def test_sound_run_is_correct():
    res, nums = execute()
    assert res["correct"], nums


@pytest.mark.parametrize("fault", sorted(
    f for f in faults.FAULTS if faults.applies(f, spec.load_cell(CELL))))
def test_fault_is_not_correct(fault):
    undo = faults.plant(fault)
    try:
        res, nums = execute()
    finally:
        for u in undo:
            u()
    assert not res["correct"], nums
    limits = check.load(CELL)["limits"]
    assert max(nums[k] / limits[k] for k in limits) > 2, nums


def test_cell_has_the_mesh_faults_and_no_loop_fault():
    assert {f for f in faults.FAULTS
            if faults.applies(f, spec.load_cell(CELL))} == {
        "half_the_samples", "altered_paths", "shadow_ignores_mesh",
        "tenth_dropped"}
