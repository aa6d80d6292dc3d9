"""How far a 1-ulp change of the primary rays moves the mid-resolution tile
means: the bound of ``tests/test_golden.py::test_golden_midres`` (a tile
mean off by more than 2e-3 * |g| + 2e-4 * scale) applied between two
renders of the port itself on the CPU.

For a preset at 256x256, spp 2, depth 2, seed 0, ``traversal="dense"``,
it prints (1) the share of tile means of the chosen 16-row tile bands off
the golden (``tests/golden/<preset>_256_tiles.npy``), and (2) the share
off the port's own frame after moving each ray direction of a random
``--nudge`` share of the primary rays by one ulp (``torch.nextafter``),
with the share of pixels that then differ by more than 1e-4 * |p| + 1.0.
With ``--jax`` it also compares the two packages on the same inputs:
(3) the share of the 256x256 primary rays (seeded jitter) whose direction
the port's ``raygen`` gives bit for bit as the JAX ``raygen`` does under
``jax.jit`` with the camera an argument, as ``render_frame`` passes it,
and (4) given the JAX package's rays, the share of pixels of the port's
``trace`` (seeded uniforms, depth 2, dense) off the JAX ``trace``'s by
more than 1e-4 * |j| + 1.0.

    python tests/midres_sensitivity.py [--preset realtime] [--bands 3,7,10,13|all]
        [--nudge 0.17] [--jax]
"""
import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import raytracinggpu_tpu_torch.render.pipeline as pp  # noqa: E402
from raytracinggpu_tpu_torch.core.rng import PRNGKey  # noqa: E402
from raytracinggpu_tpu_torch.core.vec import Vec3  # noqa: E402
from raytracinggpu_tpu_torch.scene.presets import build_preset  # noqa: E402
from tests.regen_goldens_midres import (  # noqa: E402
    GOLDEN_DIR, MIDRES, TILE, tile_means)


def render_bands(preset, bands, nudge=0.0, seed=0):
    """(tile means of the bands, their pixels) of the port's dense frame,
    the directions of a ``nudge`` share of the primary rays moved one ulp
    toward +2."""
    raygen = pp.raygen
    gen = torch.Generator().manual_seed(seed)

    def nudged(cfg, cam, jitter, rows):
        O, u = raygen(cfg, cam, jitter, rows)
        m = torch.rand(u.x.shape, generator=gen) < nudge
        return O, Vec3(*(torch.where(
            m, torch.nextafter(c, torch.full_like(c, 2.0)), c) for c in u))

    cfg, tables = build_preset(preset, "cpu", width=MIDRES, height=MIDRES,
                               spp=2, max_depth=2, traversal="dense")
    px = MIDRES // TILE
    rows = np.concatenate([np.arange(b * px, (b + 1) * px) for b in bands])
    pp.raygen = nudged if nudge else raygen
    try:
        acc, _ = pp.render_rows(tables, cfg, pp.Camera.default(cfg, "cpu"),
                                PRNGKey(0, "cpu"), rows.astype(np.int32),
                                range(cfg.spp))
    finally:
        pp.raygen = raygen
    canvas = np.zeros((MIDRES, MIDRES, 3), np.float32)
    canvas[rows] = pp.frame_rows(cfg, acc).numpy()
    return tile_means(canvas)[list(bands)], canvas[rows]


def off(tm, ref, scale):
    return float((np.abs(tm - ref) > 2e-3 * np.abs(ref) + 2e-4 * scale).mean())


def compare_with_jax(preset):
    """(3) and (4) of the module docstring."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from raytracinggpu_tpu.core.vec import Vec3 as JV
    from raytracinggpu_tpu.integrator import wavefront as jwf
    from raytracinggpu_tpu.render import pipeline as jp
    from raytracinggpu_tpu.scene.presets import build_preset as j_build
    from raytracinggpu_tpu_torch.core.rng import box_muller_terms
    from raytracinggpu_tpu_torch.integrator import wavefront as pwf

    S = MIDRES
    jcfg, jtab = j_build(preset, width=S, height=S, spp=1, max_depth=2,
                         traversal="dense")
    pcfg, ptab = build_preset(preset, "cpu", width=S, height=S, spp=1,
                              max_depth=2, traversal="dense")
    rows = np.arange(S, dtype=np.int32)
    rng = np.random.default_rng(0)
    r1, r2 = (1.0 - rng.random((2, S * S))).astype(np.float32)

    def jrays(cam, r1, r2):
        mag = np.float32(jcfg.sigma) * jnp.sqrt(-2.0 * jnp.log(r1))
        gx = mag * jnp.cos(2.0 * jnp.pi * r2)
        gy = mag * jnp.sin(2.0 * jnp.pi * r2)
        return jp.raygen(jcfg, cam, gx, gy, rows)

    Oj, uj = jax.jit(jrays)(jp.Camera.default(jcfg), r1, r2)
    _, up = pp.raygen(pcfg, pp.Camera.default(pcfg, "cpu"), box_muller_terms(
        torch.from_numpy(r1), torch.from_numpy(r2), pcfg.sigma), rows)
    U = np.stack([np.asarray(c) for c in uj], -1)
    same = (torch.stack(tuple(up), -1).numpy() == U).all(-1).mean()
    print(f"{preset}: the port's raygen gives {same:.4%} of the JAX "
          "package's jitted primary rays bit for bit")
    O = np.stack([np.asarray(c) for c in Oj], -1)
    un = (1.0 - rng.random((2, 2, S * S))).astype(np.float32)
    cj, _ = jax.jit(jwf.trace, static_argnums=1)(
        jtab, jcfg, JV(*(jnp.asarray(O[:, i]) for i in range(3))), uj,
        jnp.asarray(un))
    tv = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                          for i in range(3)))
    cp, _ = pwf.trace(ptab, dataclasses.replace(pcfg, max_depth=2), tv(O),
                      tv(U), torch.from_numpy(un))
    a = np.stack([np.asarray(c) for c in cj], -1)
    b = torch.stack(tuple(cp), -1).numpy()
    pix = (np.abs(b - a) > 1e-4 * np.abs(a) + 1.0).any(-1).mean()
    print(f"{preset}: on the JAX package's primary rays the port's depth-2 "
          f"trace has {pix:.4%} of {len(a)} pixels off the JAX trace's")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--preset", default="realtime")
    ap.add_argument("--bands", default="3,7,10,13")
    ap.add_argument("--nudge", type=float, default=0.17)
    ap.add_argument("--jax", action="store_true")
    a = ap.parse_args(argv)
    bands = (tuple(range(TILE)) if a.bands == "all"
             else tuple(int(b) for b in a.bands.split(",")))
    torch.set_num_threads(4)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{a.preset}_256_tiles.npy"))
    scale = float(np.abs(golden).mean())
    tm, img = render_bands(a.preset, bands)
    print(f"{a.preset} bands {bands}: {off(tm, golden[list(bands)], scale):.4%}"
          " of the tile means off the golden")
    tn, imgn = render_bands(a.preset, bands, a.nudge)
    pix = (np.abs(imgn - img) > 1e-4 * np.abs(img) + 1.0).any(-1).mean()
    print(f"{a.preset}: a 1-ulp nudge of {a.nudge:.0%} of the primary rays "
          f"puts {off(tn, tm, scale):.4%} of the tile means and {pix:.4%} of "
          "the pixels off the port's own frame")
    if a.jax:
        compare_with_jax(a.preset)


if __name__ == "__main__":
    main()
