"""The port's Renderer facade (raytracinggpu_tpu_torch/api.py) against the
JAX package's, on ``device="cpu"``.

Frames are held under ``tests/test_golden.py``'s bound: fewer than 0.5%
of pixels off by more than 1e-4*|g| + 1.0 (the uniforms are bitwise the
JAX package's, so frames differ only where the last bits of a cast flip
a path; see tests/test_torch_pipeline.py).  At 16x16 the bound allows
one pixel.
"""
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.api import Renderer as JRenderer
from raytracinggpu_tpu_torch import Renderer
from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
from raytracinggpu_tpu_torch.render.image_io import read_png

torch.set_num_threads(2)

SIZE = dict(width=16, height=16, spp=2, max_depth=2)


def _frac_off(img, ref):
    bad = np.abs(img - ref) > 1e-4 * np.abs(ref) + 1.0
    return bad.any(-1).mean()


@pytest.fixture(scope="module")
def soup(tmp_path_factory):
    """A 2,000-triangle soup OBJ (bench/big_mesh.py's generator) in the
    cat's region."""
    path = tmp_path_factory.mktemp("obj") / "soup.obj"
    soup_obj(str(path), 2000)
    return str(path)


@pytest.mark.parametrize("traversal", ["pairs", "pallas"])
def test_custom_obj_frame_matches_jax(soup, traversal):
    kw = dict(obj_path=soup, bvh_builder="lbvh", traversal=traversal, **SIZE)
    r = Renderer("array_bvh", device="cpu", **kw)
    assert r.scene.mesh.n_tri == 2000 and r.device == torch.device("cpu")
    img, stats = r.render_hdr(seed=0)
    ref, _ = JRenderer("array_bvh", **kw).render_hdr(seed=0)
    assert img.shape == (16, 16, 3) and np.isfinite(img).all()
    assert stats.hit.tolist() == [16 * 16 * 2] * 2
    assert _frac_off(img, np.asarray(ref)) < 0.005


def test_lbvh_cat_frame_matches_jax():
    r = Renderer("array_bvh", bvh_builder="lbvh", device="cpu", **SIZE)
    ref = JRenderer("array_bvh", bvh_builder="lbvh", **SIZE)
    img, _ = r.render_hdr(seed=1)
    assert _frac_off(img, np.asarray(ref.render_hdr(seed=1)[0])) < 0.005
    # the LBVH's tree, not the midpoint builder's
    mid = Renderer("array_bvh", device="cpu", **SIZE)
    assert r.scene.pairs_mesh.fields.shape != mid.scene.pairs_mesh.fields.shape \
        or not torch.equal(r.scene.pairs_mesh.slot_src,
                           mid.scene.pairs_mesh.slot_src)


def test_render_and_save(soup, tmp_path):
    r = Renderer("array_bvh", obj_path=soup, obj_scale=1.0,
                 obj_offset=(0.0, 1.0, 0.0), device="cpu", width=12,
                 height=12, spp=1, max_depth=1)
    img = r.render(seed=0)
    assert img.shape == (12, 12, 3) and img.dtype == np.uint8
    p = tmp_path / "api.png"
    r.save(str(p), seed=0)
    np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize("device", ["cpu", None])
def test_unknown_preset_is_value_error(device):
    with pytest.raises(ValueError, match="unknown preset"):
        Renderer("bogus", bvh_builder="lbvh", device=device)


def test_showcase_with_obj_is_value_error(soup):
    with pytest.raises(ValueError, match="showcase"):
        Renderer("showcase", obj_path=soup, device="cpu")


def test_default_device_needs_cuda(monkeypatch):
    """No quiet CPU fallback: without a CUDA device the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Renderer("array_bvh", **SIZE)


def test_smooth_preset_without_normals_falls_back(tmp_path):
    """A custom OBJ without vn records on the smooth-shading realtime
    preset renders with geometric normals, with a warning, as in the JAX
    package."""
    p = tmp_path / "plain.obj"
    p.write_text("v -3 0 10\nv 3 0 10\nv 0 4 10\nf 1 2 3\n")
    kw = dict(obj_path=str(p), width=16, height=16, spp=1, max_depth=2)
    with pytest.warns(UserWarning, match="no vertex normals"):
        r = Renderer("realtime", device="cpu", **kw)
    with pytest.warns(UserWarning, match="no vertex normals"):
        jr = JRenderer("realtime", **kw)
    assert not r.cfg.smooth_normals and not jr.cfg.smooth_normals
    img, _ = r.render_hdr(seed=0)
    assert np.isfinite(img).all()
    assert _frac_off(img, np.asarray(jr.render_hdr(seed=0)[0])) < 0.005


def test_animate_batched_matches_single():
    r = Renderer("array_bvh", device="cpu", width=16, height=16, spp=1,
                 max_depth=1)
    a = list(r.animate(3, seed=2, batch=1))
    b = list(r.animate(3, seed=2, batch=2))  # one batch of 2, then 1
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert a[0].shape == (16, 16, 3) and a[0].dtype == np.uint8
    assert not np.array_equal(a[0], a[1])  # the light moved


def test_render_sharded_without_a_group_is_render_hdr():
    """With no torch.distributed group the world is this process alone: a
    1x1 mesh, and the frame and TraceStats of render_hdr bit for bit (the
    multi-rank cases: tests/test_torch_sharding.py)."""
    r = Renderer("array_bvh", device="cpu", width=8, height=8, spp=2,
                 max_depth=2, traversal="pallas")
    img, stats = r.render_sharded(seed=4)
    ref, ref_stats = r.render_hdr(seed=4)
    assert img.dtype == np.float32 and img.shape == (8, 8, 3)
    np.testing.assert_array_equal(img, ref)
    for a, b in zip(stats, ref_stats):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("over", [
    dict(traversal="bvh"), dict(traversal="bvh", bvh_node_layout="aos10"),
    dict(pairs_cluster="sah", pairs_pack="pave", pairs_cut=32)])
def test_renderer_takes_the_slice_modes(over):
    """The Renderer passes the bvh traversal and the clustering knobs to
    its scene, as the JAX Renderer does; each renders the frame of the
    default pairs scene within the frame standard (clusterings bitwise)."""
    size = dict(width=16, height=16, spp=1, max_depth=2)
    r = Renderer("array_bvh", device="cpu", **size, **over)
    for k, v in over.items():
        assert getattr(r.cfg, k) == v
    img, _ = r.render_hdr(seed=0)
    ref, _ = Renderer("array_bvh", device="cpu", **size).render_hdr(seed=0)
    if "traversal" in over:
        assert _frac_off(img, ref) < 0.005
    else:
        np.testing.assert_array_equal(img, ref)


def test_animate_spins_the_mesh():
    """Renderer("realtime", animate_mesh=True).animate() runs the
    animated loop, and its batched frames equal single ones (the poses
    themselves: tests/test_torch_transform.py)."""
    kw = dict(width=12, height=12, spp=1, max_depth=1, traversal="bvh",
              animate_mesh=True)
    r = Renderer("realtime", device="cpu", **kw)
    a = list(r.animate(2, light_speed=0.0, batch=1, reset_each=True))
    b = list(r.animate(2, light_speed=0.0, batch=2, reset_each=True))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
