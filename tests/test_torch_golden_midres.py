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

Five presets are held against the stored goldens.  The ``realtime``
preset is held by the JAX package's own render on the same host instead
(ROADMAP C4): its stored golden cannot hold a second implementation of
so sensitive a preset, since the JAX package's own frame misses it on
some hosts, and a 1-ulp nudge of 17% of the port's primary rays moves
18.75% of the bands' tile means off the port's own frame
(``tests/midres_sensitivity.py``).  Its primary rays differ from the
JAX package's in the last bit on some lanes (XLA:CPU rounds the quirk
camera's sums as its loops fuse them), and a ray's last bit flips a path
at that scene's seams and smooth-normal grazes.  So:

- ``test_realtime_midres_on_jax_primary_rays``: both packages trace the
  JAX package's primary rays of the bands (its ``raygen`` under
  ``jax.jit`` with the camera an argument, as its ``render_frame`` passes
  it) with the same seeded uniforms (dense, depth 2, spp 2) on the CPU,
  and the port's bands are held against the JAX bands under the bounds
  above (the JAX render in the golden's place) and the per-frame bound of
  ``tests/test_golden.py``: fewer than 0.5% of pixels off by more than
  1e-4 * |j| + 1.0;
- ``test_realtime_raygen_matches_jax``: the port's own ``raygen`` for the
  same bands against the JAX one, rtol 1e-5 on every component of every
  lane (ROADMAP Queue C's per-cast tolerance).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.integrator import wavefront as jwf
from raytracinggpu_tpu.render import pipeline as jp
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.core.rng import PRNGKey, box_muller_terms
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.integrator import wavefront as pwf
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    frame_rows,
    raygen,
    render_rows,
)
from raytracinggpu_tpu_torch.scene.presets import PRESET_NAMES, build_preset
from tests.regen_goldens_midres import GOLDEN_DIR, MIDRES, TILE, tile_means

torch.set_num_threads(2)

BANDS = (3, 7, 10, 13)  # tile rows of the 16x16 grid
# the presets held against their stored goldens (realtime: see above)
GOLDEN_PRESETS = tuple(p for p in PRESET_NAMES if p != "realtime")


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


def _hold_tiles(tm, golden, scale, what):
    """tests/test_golden.py::test_golden_midres's two bounds."""
    tol = 2e-3 * np.abs(golden) + 2e-4 * scale
    frac = float((np.abs(tm - golden) > tol).mean())
    assert frac <= 0.06, (
        f"{what}: {frac:.2%} of the bands' tile means deviate")
    gross = np.abs(tm - golden) > 0.15 * np.abs(golden) + 2e-3 * scale
    assert not gross.any(), (
        f"{what}: {int(gross.sum())} tiles deviate grossly (>15%)")


@pytest.mark.parametrize("preset", GOLDEN_PRESETS)
def test_golden_midres(preset):
    golden = np.load(os.path.join(GOLDEN_DIR, f"{preset}_256_tiles.npy"))
    scale = float(np.abs(golden).mean())
    _hold_tiles(_band_tile_means(preset), golden[list(BANDS)], scale,
                f"{preset} against the CPU golden")


@pytest.fixture(scope="module")
def realtime_rays():
    """The bands' rows, the two samples' seeded uniforms (r1, r2 of the
    jitter), the JAX package's primary rays (O, u) as (2 R, 3) arrays and
    the port's own from the same uniforms."""
    jcfg, _ = j_build_preset("realtime", width=MIDRES, height=MIDRES, spp=2,
                             max_depth=2, traversal="dense")
    pcfg, _ = build_preset("realtime", "cpu", width=MIDRES, height=MIDRES,
                           spp=2, max_depth=2, traversal="dense")
    px = MIDRES // TILE
    rows = np.concatenate([np.arange(b * px, (b + 1) * px)
                           for b in BANDS]).astype(np.int32)
    n = len(rows) * MIDRES
    rng = np.random.default_rng(0)
    r = (1.0 - rng.random((2, 2, n))).astype(np.float32)  # (sample, r1|r2)

    def jrays(cam, r1, r2):
        mag = np.float32(jcfg.sigma) * jnp.sqrt(-2.0 * jnp.log(r1))
        return jp.raygen(jcfg, cam, mag * jnp.cos(2.0 * jnp.pi * r2),
                         mag * jnp.sin(2.0 * jnp.pi * r2), rows)

    f = jax.jit(jrays)
    cam = jp.Camera.default(jcfg)
    pcam = Camera.default(pcfg, "cpu")
    jO, ju, pO, pu = [], [], [], []
    for r1, r2 in r:
        O, u = f(cam, r1, r2)
        jO.append(np.stack([np.asarray(c) for c in O], -1))
        ju.append(np.stack([np.asarray(c) for c in u], -1))
        O, u = raygen(pcfg, pcam, box_muller_terms(
            torch.from_numpy(r1), torch.from_numpy(r2), pcfg.sigma), rows)
        pO.append(torch.stack(tuple(O), -1).numpy())
        pu.append(torch.stack(tuple(u), -1).numpy())
    cat = np.concatenate
    return rows, cat(jO), cat(ju), cat(pO), cat(pu)


def test_realtime_raygen_matches_jax(realtime_rays, capsys):
    _, jO, ju, pO, pu = realtime_rays
    np.testing.assert_allclose(pO, jO, rtol=1e-5, atol=0)
    np.testing.assert_allclose(pu, ju, rtol=1e-5, atol=0)
    same = float((pu == ju).all(-1).mean())
    with capsys.disabled():
        print(f"\nrealtime bands: the port's raygen gives {same:.4%} of the "
              f"JAX package's {len(ju)} primary rays bit for bit")


def test_realtime_midres_on_jax_primary_rays(realtime_rays):
    rows, jO, ju, _, _ = realtime_rays
    jcfg, jtab = j_build_preset("realtime", width=MIDRES, height=MIDRES,
                                spp=2, max_depth=2, traversal="dense")
    pcfg, ptab = build_preset("realtime", "cpu", width=MIDRES, height=MIDRES,
                              spp=2, max_depth=2, traversal="dense")
    n2 = len(ju)
    un = (1.0 - np.random.default_rng(1).random((2, 2, n2))).astype(
        np.float32)
    cj, _ = jax.jit(jwf.trace, static_argnums=1)(
        jtab, jcfg, JV(*(jnp.asarray(jO[:, i]) for i in range(3))),
        JV(*(jnp.asarray(ju[:, i]) for i in range(3))), jnp.asarray(un))
    tv = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                          for i in range(3)))
    cp, stats = pwf.trace(ptab, pcfg, tv(jO), tv(ju), torch.from_numpy(un))
    assert stats.hit.tolist() == [n2, n2]

    def frame(c):  # (2 samples, rows, W, 3): the mean of the two
        img = np.stack([np.asarray(x) for x in c], -1).reshape(
            2, len(rows), MIDRES, 3)
        canvas = np.zeros((MIDRES, MIDRES, 3), np.float32)
        canvas[rows] = (img[0] + img[1]) / np.float32(2)
        return canvas

    want, got = frame(cj), frame(tuple(cp))
    assert np.isfinite(got).all()
    bad = np.abs(got[rows] - want[rows]) > 1e-4 * np.abs(want[rows]) + 1.0
    assert bad.any(-1).mean() < 0.005
    jt = tile_means(want)[list(BANDS)]
    _hold_tiles(tile_means(got)[list(BANDS)], jt, float(np.abs(jt).mean()),
                "realtime on the JAX package's primary rays")
