"""How ``correct`` is decided: frames the window finished, compared with
the plain reference (``reference.py``) rendered from the same seed and OBJ.

Each kept frame is compared on ``rows`` of its rows drawn from the seed.
The reference rounds as the program does (sums fused, roots correctly
rounded), so most pixels agree bitwise; a few differ where the two round
a path onto another branch (a grazing triangle edge, where the
reference's classic Moller-Trumbore and the program's feature rows part,
and the paths after it).  The numbers compared:

- ``px_off_share``: the share of the compared pixels whose largest
  channel's |program - reference| / (|reference| + 1) exceeds ``TAU_OFF``:
  a fault in any layer moves every pixel that one of its paths reaches,
  the cat's shading, shadows and bounced light included;
- ``mean_gap``: |sum of program - sum of reference| / sum of reference
  over the compared pixels;
- ``display_off`` (the realtime loop): the share of the kept frame's
  display bytes that differ from the reference's tone map (gamma 1/2.2 in
  float64, clamped at 255) of the program's accumulation over the frames
  it holds.
  The accumulation of earlier frames is the program's own state: each
  frame's radiance is checked as the accumulation's step.

The limits of a cell are in ``checks/<cell>.json``, beside the readings
they were set from.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from benchmark import reference

HERE = os.path.dirname(os.path.abspath(__file__))
# a pixel is off where its error passes this: some ten times the rounding
# of a realtime frame recovered as the step of an accumulation of 600
# frames
TAU_OFF = 1e-3


def load(cell_name: str) -> dict:
    """The check of a cell: frames and rows compared, and the limits."""
    with open(os.path.join(HERE, "checks", f"{cell_name}.json")) as f:
        return json.load(f)


def rows_of(seed: int, index: int, height: int, n: int) -> np.ndarray:
    """The rows of a kept frame that are compared, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 2, int(index)])
    return np.sort(rng.choice(height, size=min(n, height), replace=False))


def frame_numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    """px_off_share and mean_gap of the program's rows against the
    reference's, both (nr, W, 3)."""
    if not np.isfinite(prog).all():
        return {"px_off_share": float("inf"), "mean_gap": float("inf")}
    prog = prog.astype(np.float64)
    ref = ref.astype(np.float64)
    err = (np.abs(prog - ref) / (np.abs(ref) + 1.0)).max(-1)
    gap = abs(prog.sum() - ref.sum()) / max(abs(ref.sum()), 1e-30)
    return {"px_off_share": float((err > TAU_OFF).mean()),
            "mean_gap": float(gap)}


def tonemap(img, dtype=torch.float64) -> np.ndarray:
    """The reference's display: gamma 1/2.2, clamped to [0, 255], uint8,
    computed in ``dtype``."""
    x = torch.as_tensor(np.asarray(img)).to(dtype)
    out = torch.clamp_max(torch.clamp_min(x, 0.0).pow(1.0 / 2.2), 255.0)
    return out.to(torch.uint8).numpy()


def view_of(cell, settings=None) -> dict:
    """The configuration's view, sized as the run renders it."""
    view = dict(cell.config["view"])
    for k in ("width", "height"):
        if settings and k in settings:
            view[k] = settings[k]
    return view


def reference_rows(cell, sc, item: dict, rows, view) -> np.ndarray:
    """The reference's radiance of a kept frame's rows."""
    t = cell.traffic
    dev = sc.sc.device
    key = reference.seed_key(item["seed"], dev)
    L0 = np.asarray(cell.config["scene"]["light"], np.float32)
    if "frame" in item:  # a frame of the realtime loop
        key = reference.fold_in(key, item["frame"])
        L = reference.orbit_light(L0, item["frame"], t["light_speed"],
                                  t["dt"])
    else:
        L = L0
    with torch.no_grad():
        img = reference.render_rows(sc, view, key, rows, t["spp"],
                                    t["max_depth"], L)
    return img.cpu().numpy()


def compare(cell, items, obj_path: str, device, n_rows: int,
            settings=None, dtype=torch.float32, each=None) -> dict:
    """The numbers of every kept frame, each the worst over the frames;
    a list ``each`` receives every frame's own."""
    view = view_of(cell, settings)
    sc = reference.build_scene(cell.config["scene"], obj_path, device, dtype)
    worst: dict = {}
    for i, item in enumerate(items):
        rows = rows_of(item["seed"], i, view["height"], n_rows)
        ref = reference_rows(cell, sc, item, rows, view)
        nums = frame_numbers(item["radiance"][rows], ref)
        if "display" in item:
            want = tonemap(item["accum"] / np.float32(item["frame"] + 1))
            nums["display_off"] = float((want != item["display"]).mean())
        if each is not None:
            each.append(dict(nums, frame=item.get("frame")))
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
    return worst


def control(cell, items, obj_path: str, device, n_rows: int, settings=None,
            dtype=torch.bfloat16) -> dict:
    """The control: the reference in ``dtype`` put in the program's place,
    compared as the program is: its radiance of the compared rows and, in
    the realtime loop, its tone map of the accumulation."""
    view = view_of(cell, settings)
    low = reference.build_scene(cell.config["scene"], obj_path, device, dtype)
    frames = []
    for i, item in enumerate(items):
        rows = rows_of(item["seed"], i, view["height"], n_rows)
        prog = np.zeros((view["height"], view["width"], 3), np.float32)
        prog[rows] = reference_rows(cell, low, item, rows, view)
        frames.append(dict(item, radiance=prog))
        if "display" in item:
            frames[-1]["display"] = tonemap(
                item["accum"] / np.float32(item["frame"] + 1), dtype)
    return compare(cell, frames, obj_path, device, n_rows, settings)


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct: every number compared is finite and within its limit."""
    return all(k in numbers and np.isfinite(numbers[k])
               and numbers[k] <= lim for k, lim in limits.items())
