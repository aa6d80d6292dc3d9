"""The port's frame pipeline end to end
(raytracinggpu_tpu_torch/render/pipeline.py, scene/presets.py).

The 48x48, spp 2, depth 2, seed 0 ``array_bvh`` frame is held against
the JAX package's ``pairs`` frame and against the stored golden
(``tests/golden/array_bvh_48.npy``) under ``tests/test_golden.py``'s
bound: fewer than 0.5% of pixels off by more than 1e-4*|g| + 1.0.  The
uniforms are bitwise the JAX package's, so the frames differ only where
the last bits of a cast flip a path (see tests/test_torch_integrator.py).
Measured: 0.13% of pixels off against the JAX frame, 0.22% against the
golden.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracinggpu_tpu.render.image_io import tonemap as j_tonemap
from raytracinggpu_tpu.render.pipeline import (
    render_preset_frame as j_render_preset_frame,
)
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.render.image_io import tonemap
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    chunk_size,
    group_size,
    pairs_cast_width,
    rays_per_frame,
    render_preset_frame,
)
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "array_bvh_48.npy")
SIZE = dict(width=48, height=48, spp=2, max_depth=2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def port():
    cfg, tables = build_preset("array_bvh", "cpu", **SIZE)
    img, stats = render_preset_frame(tables, cfg, seed=0)
    return cfg, tables, img, stats


@pytest.fixture(scope="module")
def frames():
    """Frames of the port's tables by config, rendered once a module."""
    return {}


@pytest.fixture(scope="module")
def jax_frame():
    cfg, tables = j_build_preset("array_bvh", traversal="pairs", **SIZE)
    return j_render_preset_frame(tables, cfg, seed=0)[0]


def _frac_off(img, ref):
    bad = np.abs(img - ref) > 1e-4 * np.abs(ref) + 1.0
    return bad.any(-1).mean()


def test_frame_matches_jax_pairs_frame(port, jax_frame):
    img = port[2]
    assert img.shape == (48, 48, 3) and img.dtype == np.float32
    assert np.isfinite(img).all()
    assert _frac_off(img, jax_frame) < 0.005


def test_frame_matches_golden(port):
    assert _frac_off(port[2], np.load(GOLDEN)) < 0.005


def test_every_ray_hits_and_the_cat_shadows(port):
    cfg, _, _, stats = port
    n = cfg.width * cfg.height * cfg.spp
    assert stats.hit.tolist() == [n] * cfg.max_depth
    assert stats.diffuse.tolist() == [n] * cfg.max_depth
    assert (stats.shadowed > 0).all()


def test_same_seed_same_frame(port):
    cfg, tables, img, _ = port
    again, _ = render_preset_frame(tables, cfg, seed=0)
    np.testing.assert_array_equal(again, img)
    other, _ = render_preset_frame(tables, cfg, seed=1)
    assert not np.array_equal(other, img)


@pytest.mark.parametrize("over,against", [
    ({"spp_fuse": 1}, {}), ({"pairs_chunk": 4096}, {}),
    ({"pairs_chunk": None}, {"pairs_chunk": 4096})])
def test_grouping_and_chunking_bitwise(port, frames, over, against):
    """One sample per wavefront instead of two, or 4096-ray casts instead
    of one 8192-ray cast, give the same frame bit for bit; so does the
    default config, whose wavefront ``group_size`` sizes to both samples
    and whose pairs casts ``pairs_cast_width`` sizes (one cast holds the
    wavefront here), against 4096-ray casts of one sample each."""
    cfg, tables, img, stats = port
    cfg1, cfg2 = (dataclasses.replace(cfg, **o) for o in (over, against))
    lanes = cfg.width * cfg.height
    R = lanes * cfg.spp

    def casts(c):
        g = group_size(c, cfg.spp, lanes, tables)
        return g, chunk_size(c, g * lanes, scene=tables)

    assert casts(cfg1) != casts(cfg2)
    if cfg1 == cfg:
        assert casts(cfg1) == (2, pairs_cast_width(cfg1, R, tables)) \
            == (2, 8192)
    frames.setdefault(cfg, (img, stats))
    for c in (cfg1, cfg2):
        if c not in frames:
            frames[c] = render_preset_frame(tables, c, seed=0)
    (img1, stats1), (img2, stats2) = frames[cfg1], frames[cfg2]
    np.testing.assert_array_equal(img1, img2)
    for a, b in zip(stats1, stats2):
        np.testing.assert_array_equal(a, b)


def test_tonemap_and_ray_count(port):
    img = port[2]
    np.testing.assert_array_equal(tonemap(img), j_tonemap(img))
    np.testing.assert_array_equal(tonemap(torch.from_numpy(img)),
                                  j_tonemap(img))
    assert rays_per_frame(port[0]) == 48 * 48 * 2 * 5


def test_camera_needs_an_explicit_device(port):
    cfg = port[0]
    cam = Camera.default(cfg, "cpu")
    assert [float(c) for c in cam.C] == [0.0, 0.0, 55.0]
    assert all(c.device.type == "cpu" for v in cam for c in v)
    with pytest.raises(TypeError):
        Camera.default(cfg)


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port (the entry points api, cli.main,
    bench.big_mesh, bench.micro_kernel and bench.sweep, and the slice of
    scene.transform, ops.bvh_traverse and accel.sah among them; not the
    CLI's __main__, which runs it)
    imports in a fresh process without jax or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import raytracinggpu_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.') if not m.name.endswith('.__main__')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "need = {'api', 'cli.main', 'bench.big_mesh', 'accel.lbvh', "
        "'bench.micro_kernel', 'bench.sweep', 'bench._timing', "
        "'scene.transform', 'ops.bvh_traverse', 'accel.sah'}\n"
        "assert need <= {m[len(p.__name__) + 1:] for m in mods}, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'raytracinggpu_tpu' or "
        "m.startswith('raytracinggpu_tpu.'))\n"
        "assert len(mods) >= 15, mods\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
