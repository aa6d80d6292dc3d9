"""The port's tiled-kernel traversal (``traversal="pallas"``) against the
JAX package's (raytracinggpu_tpu_torch/ops/pallas_trace.py, the pallas
branches of integrator/wavefront.py, the pipeline's cast size).

Inputs are made with numpy from a seed and go through both packages on
identical tables; the JAX kernels run in Pallas interpret mode, as the
JAX package's own tests run them on the CPU, at the production subgroup
of 64 rays.

- The tables, the ray-sort key and the culling lists have no multiply-add:
  bitwise (the JAX lists are int8, the port's int32).
- The mesh queries are held per lane, the Queue C per-cast standard: a
  lane agrees when hit/miss and the winner index agree and, where both
  hit, t is within rtol 1e-5; >= 99.9% of lanes must agree, and
  |dt| <= 1e-5 * max(t, 1) everywhere.  The JAX kernel's sums are
  contracted into FMAs by XLA:CPU while the port rounds every product
  (its CUDA kernel must equal its plain version bit for bit), and the
  JAX package computes the ray features O x u outside jit, unfused, where
  the port rounds them as the jitted integrator does.
- The recovered barycentrics and the fused smooth normal, on the same
  winners: within 1e-5 and 5e-5 absolute (normalized), the B3 standard
  of tests/test_torch_pairs.py.
- Frames: ``tests/test_golden.py``'s bound (fewer than 0.5% of pixels off
  by more than 1e-4*|g| + 1.0) against the JAX frame of the same
  traversal and the golden; bitwise across ``ray_sort``,
  ``pallas_subgroup`` and the cast size, since a ray's culled tiles only
  add hits beyond its cap, which lose the merge.

Measured on these inputs: every lane agrees on hit/miss and index, t
within 2.2e-7 relative on the camera rays and 3.9e-6 on the scattered
ones, capped or not; the barycentrics bit for bit; the normalized smooth
normal within 1.4e-6; the 48x48 frame 1 pixel off the JAX pallas frame
and 3 off the golden (the JAX frame: 2), the realtime frame 1 pixel off.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.integrator import wavefront as jwf
from raytracinggpu_tpu.ops import pallas_trace as jpt
from raytracinggpu_tpu.render import pipeline as jp
from raytracinggpu_tpu.render.pipeline import (
    render_preset_frame as j_render_preset_frame,
)
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.integrator import wavefront as pwf
from raytracinggpu_tpu_torch.ops import pallas_trace as ppt
from raytracinggpu_tpu_torch.ops.triangle import TriHit
from raytracinggpu_tpu_torch.render import pipeline as pp
from raytracinggpu_tpu_torch.scene.presets import build_preset
from tests.test_torch_pairs import _agree, _jv, _pv

torch.set_num_threads(2)

SUBG, EPS = 64, 1e-4
KINDS = ("camera", "scattered")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "array_bvh_48.npy")
SIZE = dict(width=48, height=48, spp=2, max_depth=2)


@pytest.fixture(scope="module")
def scene():
    jcfg, jtab = j_build_preset("array_bvh", traversal="pallas")
    jnp_tab = jax.tree.map(np.asarray, jtab)
    pcfg, ptab = build_preset("array_bvh", "cpu", traversal="pallas")
    return jcfg, jtab, jnp_tab, pcfg, ptab


def _rays(kind, R=3000, seed=0):
    """(O, u) (3, R) f32: a fan from the camera toward the cat, or random
    rays inside the box."""
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        O = rng.uniform(-25, 25, (3, R)).astype(np.float32)
    else:
        O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, R))
    d = rng.normal(size=(3, R)).astype(np.float32)
    if kind != "scattered":
        d[2] = -np.abs(d[2]) * 4.0 - 2.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return O, d.astype(np.float32)


def _frac_off(img, ref):
    bad = np.abs(img - ref) > 1e-4 * np.abs(ref) + 1.0
    return bad.any(-1).mean()


def _cap(O, u, scene):
    """The nearest sphere hit, the integrator's cap."""
    return pwf.intersect_spheres(_pv(O), _pv(u), scene[4].spheres)[0]


# ------------------------------------------------------------------ tables

@pytest.mark.parametrize("field", ["fields", "fieldsT", "tile_aabb"])
def test_pallas_tables_bitwise(scene, field):
    """The cat: 3954 triangles padded to 4096, 32 tiles, the last of them
    padding only (its box inverted)."""
    _, _, jtab, _, ptab = scene
    a = getattr(ptab.pallas_mesh, field).numpy()
    b = getattr(jtab.pallas_mesh, field)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    assert ptab.pallas_mesh.n_tiles == int(jtab.pallas_mesh.n_tiles) == 32
    aabb = ptab.pallas_mesh.tile_aabb
    assert (aabb[31, :3] > aabb[31, 3:6]).all()
    assert (aabb[:31, :3] <= aabb[:31, 3:6]).all()


def test_convert_carries_the_mesh_tables(scene):
    _, _, jtab, _, ptab = scene
    conv = scene_tables_from_numpy(jtab, "cpu")
    assert conv.pallas_mesh.n_tiles == ptab.pallas_mesh.n_tiles
    for f in ("fields", "fieldsT", "tile_aabb"):
        assert torch.equal(getattr(conv.pallas_mesh, f),
                           getattr(ptab.pallas_mesh, f))
    assert conv.mesh.n_tri == ptab.mesh.n_tri
    assert torch.equal(conv.mesh.mt, ptab.mesh.mt)
    assert torch.equal(conv.mesh.cornersT, ptab.mesh.cornersT)
    for a, b in zip(conv.mesh.na, ptab.mesh.na):
        assert torch.equal(a, b)


# ---------------------------------------------------------- ray prep, culling

def test_ray_sort_key_and_features_match_jax():
    O, u = _rays("scattered", R=4096, seed=1)
    O[:, :8] = [[-70.0], [70.0], [-64.0]]  # clipped cells
    np.testing.assert_array_equal(
        ppt.ray_sort_key(_pv(O), _pv(u)).numpy(),
        np.asarray(jpt.ray_sort_key(_jv(O), _jv(u))))
    fj = np.asarray(jpt._ray_features16(_jv(O), _jv(u))).T
    fp = ppt._ray_features16(_pv(O), _pv(u)).numpy()
    assert fp.shape == fj.shape == (16, 4096)
    keep = [0, 1, 2, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15]
    np.testing.assert_array_equal(fp[keep], fj[keep])
    np.testing.assert_allclose(fp[3:6], fj[3:6], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_block_active_tiles_match_jax(scene, kind, capped):
    """Counts and the ids in order, row for row; the padding tile never
    appears among a row's active ids."""
    _, jtab, _, _, ptab = scene
    O, u = _rays(kind, R=4096, seed=2)
    cap = _cap(O, u, scene) if capped else None
    lj = np.asarray(jpt._block_active_tiles(
        _jv(O), _jv(u), jtab.pallas_mesh.tile_aabb, 32,
        cap=None if cap is None else jnp.asarray(cap.numpy()), subg=SUBG))
    lp = ppt._block_active_tiles(_pv(O), _pv(u), ptab.pallas_mesh.tile_aabb,
                                 32, cap=cap, subg=SUBG)
    assert lp.dtype == torch.int32 and lp.shape == (4096 // SUBG, 33)
    np.testing.assert_array_equal(lp.numpy(), lj.astype(np.int32))
    counts = lp[:, 0]
    assert (counts > 0).any() and (counts < 31).all()
    for row in lp:
        assert 31 not in row[1:1 + int(row[0])].tolist()


def test_padding_tiles_are_culled(rng):
    """tests/test_pallas_trace.py's case: 100 triangles padded to 512, so
    tiles 1-3 are padding only and never listed."""
    n = 100
    A = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    B = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    C = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.3
    jtab = jpt.build_pallas_tables(A, B, C, pad_to=512)
    ptab = ppt.build_pallas_tables(A, B, C, "cpu", pad_to=512)
    assert ptab.n_tiles == jtab.n_tiles == 4
    o = rng.uniform(-10, 10, (3, 1024)).astype(np.float32)
    d = rng.standard_normal((3, 1024)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    lj = np.asarray(jpt._block_active_tiles(_jv(o), _jv(d), jtab.tile_aabb, 4))
    lp = ppt._block_active_tiles(_pv(o), _pv(d), ptab.tile_aabb, 4)
    np.testing.assert_array_equal(lp.numpy(), lj.astype(np.int32))
    for row in lp.tolist():
        assert set(row[1:1 + row[0]]) <= {0}


# ------------------------------------------------------------- mesh queries

@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_closest_matches_jax(scene, kind, capped):
    _, jtab, _, _, ptab = scene
    O, u = _rays(kind, seed=3)
    cap = _cap(O, u, scene) if capped else None
    hj = jpt.intersect_tris_pallas(
        _jv(O), _jv(u), jtab.pallas_mesh, EPS, interpret=True,
        sort_rays=False, cap=None if cap is None else jnp.asarray(cap.numpy()),
        subg=SUBG)
    hp = ppt.intersect_tris_pallas(_pv(O), _pv(u), ptab.pallas_mesh, EPS,
                                   sort_rays=False, cap=cap, subg=SUBG)
    ta, ia = np.asarray(hj.t), np.asarray(hj.idx)
    tb, ib = hp.t.numpy(), hp.idx.numpy()
    frac, scaled = _agree(ta, ia, tb, ib)
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    assert (tb < 1e9).sum() > 50
    assert (ib[tb >= 1e9] == 0).all()


@pytest.mark.parametrize("capped", [False, True])
def test_shadow_matches_jax(scene, capped):
    _, jtab, _, _, ptab = scene
    O, u = _rays("scattered", seed=5)
    cap = None
    if capped:
        cap = np.random.default_rng(5).uniform(1.0, 60.0, O.shape[1])
        cap = torch.from_numpy(cap.astype(np.float32))
    tj = np.asarray(jpt.intersect_tris_shadow(
        _jv(O), _jv(u), jtab.pallas_mesh, EPS,
        cap=None if cap is None else jnp.asarray(cap.numpy()),
        interpret=True, sort_rays=False, subg=SUBG))
    tp = ppt.intersect_tris_shadow(_pv(O), _pv(u), ptab.pallas_mesh, EPS,
                                   cap=cap, sort_rays=False, subg=SUBG)
    frac, scaled = _agree(tj, np.zeros_like(tj), tp.numpy(),
                          np.zeros_like(tj))
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    assert (tp < 1e9).sum() > 50


def test_ray_sort_keeps_every_result(scene):
    """Sorting regroups the subgroups; uncapped, every ray's closest hit
    and shadow distance stay bit for bit."""
    _, _, _, _, ptab = scene
    O, u = _pv(_rays("scattered", seed=6)[0]), _pv(_rays("scattered",
                                                         seed=6)[1])
    tab = ptab.pallas_mesh
    a = ppt.intersect_tris_pallas(O, u, tab, EPS, sort_rays=False)
    b = ppt.intersect_tris_pallas(O, u, tab, EPS, sort_rays=True)
    assert torch.equal(a.t, b.t) and torch.equal(a.idx, b.idx)
    assert torch.equal(ppt.intersect_tris_shadow(O, u, tab, EPS,
                                                 sort_rays=False),
                       ppt.intersect_tris_shadow(O, u, tab, EPS,
                                                 sort_rays=True))


def test_barycentrics_and_smooth_recovery_match_jax(scene):
    """On the same winners: recompute_barycentrics and the integrator's
    fused (R, 25) smooth-normal recovery, each against the JAX package's
    under jit (as its integrator runs it)."""
    _, jtab, _, _, ptab = scene
    O, u = _rays("camera", seed=7)
    hj = jpt.intersect_tris_pallas(_jv(O), _jv(u), jtab.pallas_mesh, EPS,
                                   interpret=True, sort_rays=False)
    hit = np.asarray(hj.t) < 1e9
    assert hit.sum() > 50
    hp = TriHit(t=torch.from_numpy(np.array(hj.t)),
                idx=torch.from_numpy(np.array(hj.idx)))
    bj = jax.jit(jpt.recompute_barycentrics)(_jv(O), _jv(u),
                                             jtab.pallas_mesh, hj)
    bp = ppt.recompute_barycentrics(_pv(O), _pv(u), ptab.pallas_mesh, hp)
    for a, b in zip(bj, bp):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   rtol=0, atol=1e-5)
    nj = jax.jit(jwf._fused_smooth_recovery)(jtab, _jv(O), _jv(u), hj)
    npt = pwf._fused_smooth_recovery(ptab, _pv(O), _pv(u), hp)
    unit = lambda n: n[:, hit] / np.linalg.norm(n[:, hit], axis=0)
    nj = unit(np.stack([np.asarray(c) for c in nj]))
    npt = unit(np.stack([c.numpy() for c in npt]))
    assert np.abs(nj - npt).max() <= 5e-5


def test_tie_lowest_index_matches_jax():
    """tests/test_big_mesh.py's coincident triangles: index 0 wins."""
    tri = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    A, B, C = (np.stack([tri[k]] * 6) for k in range(3))
    O = [np.full(8, v, np.float32) for v in (0.0, 0.0, 5.0)]
    u = [np.full(8, v, np.float32) for v in (0.0, 0.0, -1.0)]
    hj = jpt.intersect_tris_pallas(_jv(O), _jv(u),
                                   jpt.build_pallas_tables(A, B, C), EPS,
                                   interpret=True)
    hp = ppt.intersect_tris_pallas(_pv(O), _pv(u),
                                   ppt.build_pallas_tables(A, B, C, "cpu"),
                                   EPS)
    assert (np.asarray(hj.idx) == 0).all() and (hp.idx == 0).all()
    assert torch.equal(hp.t, torch.from_numpy(np.array(hj.t)))


def test_oversized_subgroup_rejected_by_both(scene):
    _, jtab, _, _, ptab = scene
    O = [np.zeros(256, np.float32)] * 3
    u = [np.zeros(256, np.float32)] * 2 + [np.ones(256, np.float32)]
    with pytest.raises(ValueError, match="pallas_subgroup"):
        jpt.intersect_tris_pallas(_jv(O), _jv(u), jtab.pallas_mesh, EPS,
                                  interpret=True, subg=256)
    with pytest.raises(ValueError, match="pallas_subgroup"):
        ppt.intersect_tris_pallas(_pv(O), _pv(u), ptab.pallas_mesh, EPS,
                                  subg=256)


# ------------------------------------------------------------------- frames

@pytest.fixture(scope="module")
def port_frame():
    cfg, tables = build_preset("array_bvh", "cpu", traversal="pallas", **SIZE)
    img, stats = pp.render_preset_frame(tables, cfg, seed=0)
    return cfg, tables, img, stats


def test_pallas_frame_matches_jax_and_golden(port_frame):
    cfg, _, img, stats = port_frame
    assert np.isfinite(img).all()
    n = cfg.width * cfg.height * cfg.spp
    assert stats.hit.tolist() == [n] * cfg.max_depth
    assert (stats.shadowed > 0).all()
    jcfg, jtab = j_build_preset("array_bvh", traversal="pallas", **SIZE)
    jimg = j_render_preset_frame(jtab, jcfg, seed=0)[0]
    assert _frac_off(img, jimg) < 0.005
    assert _frac_off(img, np.load(GOLDEN)) < 0.005


@pytest.mark.parametrize("over", [{"ray_sort": True},
                                  {"pallas_subgroup": 32},
                                  {"pairs_chunk": 2048}])
def test_pallas_frame_bitwise_across_sort_subgroup_and_casts(port_frame,
                                                             over):
    """Sorted rays, 32-ray subgroups, or three 2048-ray casts (whole
    multiples of BLK_R) instead of one 5120-ray cast: the same frame and
    stats bit for bit."""
    cfg, tables, img, stats = port_frame
    cfg2 = dataclasses.replace(cfg, **over)
    R = cfg.width * cfg.height * cfg.spp
    assert pp.chunk_size(cfg, R, "pallas") == 5120
    assert pp.chunk_size(cfg2, R, "pallas") % ppt.BLK_R == 0
    img2, stats2 = pp.render_preset_frame(tables, cfg2, seed=0)
    np.testing.assert_array_equal(img2, img)
    for a, b in zip(stats, stats2):
        np.testing.assert_array_equal(a, b)


def test_pairs_runs_as_pallas_without_pairs_tables(port_frame):
    """A JAX table whose pairs build was refused (pairs_mesh None) carries
    across as such, and traversal="pairs" then renders through the tiled
    kernels: the port's own pallas frame bit for bit."""
    cfg, _, img, _ = port_frame
    jcfg, jtab = j_build_preset("array_bvh", traversal="pairs", **SIZE)
    jtab = jax.tree.map(np.asarray, jtab)._replace(pairs_mesh=None)
    ptab = scene_tables_from_numpy(jtab, "cpu")
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    assert ptab.pairs_mesh is None and pcfg.traversal == "pairs"
    assert pwf._effective_traversal(pcfg, ptab) == "pallas"
    img2, _ = pp.render_preset_frame(ptab, pcfg, seed=0)
    np.testing.assert_array_equal(img2, img)


def test_realtime_pallas_frame_matches_jax():
    """The realtime 48x48 frame (smooth normals: the fused recovery)
    through the tiled traversal against the JAX package's."""
    cfg, tables = build_preset("realtime", "cpu", traversal="pallas", **SIZE)
    assert cfg.smooth_normals
    img, stats = pp.render_preset_frame(tables, cfg, seed=0)
    assert np.isfinite(img).all()
    assert stats.hit.tolist() == [48 * 48 * 2] * 2
    jcfg, jtab = j_build_preset("realtime", traversal="pallas", **SIZE)
    jimg, _ = jp.render_preset_frame(jtab, jcfg, seed=0)
    assert _frac_off(img, jimg) < 0.005
