"""The port's triangle tables and dense oracle traversal against the JAX
package's (raytracinggpu_tpu_torch/ops/triangle.py).

Inputs are made with numpy from a seed; both packages build their tables
from the same cat mesh.

- The tables are the same numpy code: bitwise.
- ``intersect_tris_dense`` is a (R, 10) x (10, 4T) f32 product whose
  10-term sums XLA and torch round in different orders, so it is held to
  the Queue C per-cast standard: hit/miss, id and t within rtol 1e-5
  agree on >= 99.9% of lanes, and |dt| <= 1e-5 * max(t, 1) everywhere;
  beta and gamma where the ids agree within 1e-4 absolute (cancellation
  in the numerators makes short rays' barycentrics the least exact).
- The normal gathers: geometric bitwise; smooth (on the same hits)
  within 1e-6 absolute, XLA fusing the Phong sum's products into FMAs
  where the port may round otherwise.
- The 48x48 spp 2 depth 2 seed 0 frame through ``traversal="dense"``:
  ``tests/test_golden.py``'s bound against the JAX dense frame and the
  golden (fewer than 0.5% of pixels off by more than 1e-4*|g| + 1.0).

Measured on these inputs on the CPU: the dense hits, their barycentrics
and the smooth normals equal the JAX package's bit for bit, and the frame
has 0 pixels off either reference; the tolerances hold what the
arithmetic guarantees, not what one machine's libraries happen to give.
"""
import os

import jax
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.ops import triangle as jtri
from raytracinggpu_tpu.render.pipeline import (
    render_preset_frame as j_render_preset_frame,
)
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.ops import pallas_trace as pat
from raytracinggpu_tpu_torch.ops import triangle as ptri
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.presets import build_preset
from tests.test_torch_pairs import _agree, _jv, _pv
from tests.test_torch_pallas import _rays

torch.set_num_threads(2)

EPS = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "array_bvh_48.npy")


@pytest.fixture(scope="module")
def both():
    jcfg, jtab = j_build_preset("array_bvh", traversal="dense")
    pcfg, ptab = build_preset("array_bvh", "cpu", traversal="dense")
    return jcfg, jax.tree.map(np.asarray, jtab), pcfg, ptab


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("field", ["mt", "ng", "na", "nb", "nc", "cornersT"])
def test_tri_tables_bitwise(both, field):
    _, jtab, _, ptab = both
    a, b = getattr(ptab.mesh, field), getattr(jtab.mesh, field)
    if isinstance(a, PV):
        for x, y in zip(a, b):
            _same(x.numpy(), y)
    else:
        _same(a.numpy(), b)
    assert ptab.mesh.n_tri == int(jtab.mesh.n_tri) == 3954
    assert tuple(ptab.mesh.mt.shape) == (10, 4, 4096)


def test_ray_features_match_jax():
    O, u = _rays("scattered")
    fj = np.asarray(jax.jit(jtri.ray_features)(_jv(O), _jv(u)))
    fp = ptri.ray_features(_pv(O), _pv(u)).numpy()
    assert fp.shape == fj.shape == (O.shape[1], 10)
    np.testing.assert_array_equal(fp[:, [0, 1, 2, 6, 7, 8, 9]],
                                  fj[:, [0, 1, 2, 6, 7, 8, 9]])
    np.testing.assert_allclose(fp[:, 3:6], fj[:, 3:6], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("kind", ("camera", "scattered"))
def test_dense_matches_jax(both, kind):
    _, jtab, _, ptab = both
    O, u = _rays(kind)
    hj = jax.jit(jtri.intersect_tris_dense, static_argnums=(3, 4))(
        _jv(O), _jv(u), jtab.mesh, EPS, 512)
    hp = ptri.intersect_tris_dense(_pv(O), _pv(u), ptab.mesh, EPS, 512)
    ta, ia = np.asarray(hj.t), np.asarray(hj.idx)
    tb, ib = hp.t.numpy(), hp.idx.numpy()
    assert hp.idx.dtype == torch.int32
    frac, scaled = _agree(ta, ia, tb, ib)
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    assert (tb < 1e9).sum() > 50
    miss = tb >= 1e9
    assert (ib[miss] == 0).all() and (hp.beta.numpy()[miss] == 0).all()
    same = ~miss & (ia == ib)
    for a, b in ((hj.beta, hp.beta), (hj.gamma, hp.gamma)):
        np.testing.assert_allclose(b.numpy()[same], np.asarray(a)[same],
                                   rtol=0, atol=1e-4)


def test_normals_match_jax(both):
    """Both gathers on the same (JAX dense) hits."""
    _, jtab, _, ptab = both
    O, u = _rays("camera", seed=4)
    hj = jax.jit(jtri.intersect_tris_dense, static_argnums=(3, 4))(
        _jv(O), _jv(u), jtab.mesh, EPS, 512)
    hit = np.asarray(hj.t) < 1e9
    assert hit.sum() > 50
    hp = ptri.TriHit(*(torch.from_numpy(np.array(x)) for x in hj))
    for jf, pf, atol in ((jtri.geometric_normal, ptri.geometric_normal, 0.0),
                         (jtri.smooth_normal, ptri.smooth_normal, 1e-6)):
        nj = jax.jit(jf)(jtab.mesh, hj)
        npt = pf(ptab.mesh, hp)
        for a, b in zip(nj, npt):
            np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                       rtol=0, atol=atol)


def test_dense_tie_lowest_index():
    """Coincident duplicate triangles: the lowest index wins in both
    packages (tests/test_big_mesh.py's case)."""
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    A, B, C = (np.stack([tri[k]] * 6) for k in range(3))
    O = [np.full(8, v, np.float32) for v in (0.0, 0.0, 5.0)]
    u = [np.full(8, v, np.float32) for v in (0.0, 0.0, -1.0)]
    hj = jtri.intersect_tris_dense(
        _jv(O), _jv(u), jtri.build_tri_tables(A, B, C, pad_to=512), EPS)
    hp = ptri.intersect_tris_dense(
        _pv(O), _pv(u), ptri.build_tri_tables(A, B, C, "cpu", pad_to=512),
        EPS)
    assert (np.asarray(hj.idx) == 0).all() and (hp.idx == 0).all()
    assert torch.equal(hp.t, torch.full((8,), 5.0))


def test_dense_and_tiled_traversals_agree(both):
    """The port's oracle against its tiled query (the JAX package's
    tests/test_pallas_trace.py standard), and the tiled query's recovered
    barycentrics against the oracle's."""
    _, _, _, ptab = both
    O, u = _rays("scattered", R=2048, seed=7)
    O, u = _pv(O), _pv(u)
    dh = ptri.intersect_tris_dense(O, u, ptab.mesh, EPS)
    ph = pat.intersect_tris_pallas(O, u, ptab.pallas_mesh, EPS)
    hit_d, hit_p = dh.t < 1e9, ph.t < 1e9
    assert torch.equal(hit_d, hit_p) and hit_d.sum() > 50
    np.testing.assert_allclose(ph.t[hit_p].numpy(), dh.t[hit_d].numpy(),
                               rtol=1e-5, atol=1e-5)
    same = hit_p & (ph.idx == dh.idx)
    assert same.sum() >= 0.999 * hit_p.sum()
    beta, gamma = pat.recompute_barycentrics(O, u, ptab.pallas_mesh, ph)
    for a, b in ((beta, dh.beta), (gamma, dh.gamma)):
        np.testing.assert_allclose(a[same].numpy(), b[same].numpy(),
                                   rtol=1e-3, atol=1e-4)


def test_dense_checks_the_block_and_keeps_full_f32(both):
    _, _, _, ptab = both
    O, u = _rays("camera", R=64)
    with pytest.raises(ValueError, match="tri_block"):
        ptri.intersect_tris_dense(_pv(O), _pv(u), ptab.mesh, EPS, 384)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        ptri.intersect_tris_dense(_pv(O), _pv(u), ptab.mesh, EPS)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


def test_dense_frame_matches_jax_and_golden():
    size = dict(width=48, height=48, spp=2, max_depth=2, traversal="dense")
    cfg, tables = build_preset("array_bvh", "cpu", **size)
    img, stats = render_preset_frame(tables, cfg, seed=0)
    assert np.isfinite(img).all()
    assert stats.hit.tolist() == [48 * 48 * 2] * 2
    assert (stats.shadowed > 0).all()
    jcfg, jtab = j_build_preset("array_bvh", **size)
    jimg = j_render_preset_frame(jtab, jcfg, seed=0)[0]
    for ref in (jimg, np.load(GOLDEN)):
        bad = np.abs(img - ref) > 1e-4 * np.abs(ref) + 1.0
        assert bad.any(-1).mean() < 0.005
