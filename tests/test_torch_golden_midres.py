"""The six presets of the port against the mid-resolution goldens
(``tests/golden/<preset>_256_tiles.npy``: the 16x16 grid of 16x16-pixel tile
means of the JAX package's 256x256, spp 2, depth 2, seed 0 frame through
the dense traversal on the CPU; ``tests/regen_goldens_midres.py`` writes
them).

The port renders the same frame, ``traversal="dense"`` on the CPU, under
the bounds of ``tests/test_golden.py::test_golden_midres``: at most 6% of
the tile means off by more than 2e-3 * |g| + 2e-4 * scale, and none off by
more than 0.15 * |g| + 2e-3 * scale (scale: the golden's mean |g|).

A whole 256x256 frame of a preset with the cat takes the port's dense
traversal about 70 s on two CPU threads, so each case renders the four
16-row tile bands BANDS through ``render_rows`` (a quarter of the frame:
the back wall, the cat's body and head, its feet and the floor's shadow,
in every mesh preset) and holds those bands' 64 tiles.  Rows are keyed by
their index, so these pixels are the full frame's bit for bit.

Measured on the CPU: the ``realtime`` case fails, 6.25% of its bands' tile
means off the golden (the whole frame: 7.0%).  Its primary rays differ
from the JAX package's in the last bit on some lanes (XLA:CPU rounds the
quirk camera's sums as its loops fuse them), and a ray's last bit flips a
path at that scene's seams and smooth-normal grazes; on the JAX
package's primary rays the port's depth-2 trace is off on 3 pixels of
65,536.  ``tests/midres_sensitivity.py`` measures both, and how far a
1-ulp nudge of the rays moves these tiles.  The bound stays as the JAX
test has it (ROADMAP C4).
"""
import os

import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    frame_rows,
    render_rows,
)
from raytracinggpu_tpu_torch.scene.presets import PRESET_NAMES, build_preset
from tests.regen_goldens_midres import GOLDEN_DIR, MIDRES, TILE, tile_means

torch.set_num_threads(2)

BANDS = (3, 7, 10, 13)  # tile rows of the 16x16 grid


def _band_tile_means(preset: str) -> np.ndarray:
    cfg, tables = build_preset(preset, "cpu", width=MIDRES, height=MIDRES,
                               spp=2, max_depth=2, traversal="dense")
    px = MIDRES // TILE
    rows = np.concatenate([np.arange(b * px, (b + 1) * px) for b in BANDS])
    acc, stats = render_rows(tables, cfg, Camera.default(cfg, "cpu"),
                             PRNGKey(0, "cpu"), rows.astype(np.int32),
                             range(cfg.spp))
    n = len(rows) * MIDRES * cfg.spp
    assert stats.hit.tolist() == [n, n]  # every scene is enclosed
    canvas = np.zeros((MIDRES, MIDRES, 3), np.float32)
    canvas[rows] = frame_rows(cfg, acc).numpy()
    assert np.isfinite(canvas).all()
    return tile_means(canvas)[list(BANDS)]


@pytest.mark.parametrize("preset", PRESET_NAMES)
def test_golden_midres(preset):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{preset}_256_tiles.npy"))
    scale = float(np.abs(golden).mean())
    golden = golden[list(BANDS)]
    tm = _band_tile_means(preset)
    tol = 2e-3 * np.abs(golden) + 2e-4 * scale
    frac = float((np.abs(tm - golden) > tol).mean())
    assert frac <= 0.06, (
        f"{preset}: {frac:.2%} of the bands' tile means deviate from the "
        f"CPU golden")
    gross = np.abs(tm - golden) > 0.15 * np.abs(golden) + 2e-3 * scale
    assert not gross.any(), (
        f"{preset}: {int(gross.sum())} tiles deviate grossly (>15%)")
