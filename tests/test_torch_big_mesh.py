"""Big meshes in the port against the JAX package (the pairs tables past
ST_SLOTS, where the JAX package streams its field table in supertiles:
B4; the slot ceiling and its fallback; ``bench/big_mesh.py``'s soup).

A 34,000-triangle soup (``tests/test_big_mesh.py``'s generator,
``default_rng(0)``) packs into 377 tiles: the port's table holds exactly
377 * 128 = 48,256 slots, and the JAX package pads the same table with
zero columns to 65,536 (two 32,768-slot supertiles).  Held:

- the port's tables equal the JAX tables bit for bit, the JAX fields'
  first 48,256 columns included, and the JAX tail is zero;
- 256 rays through the port's ``intersect_tris_pairs(payload="geom")``
  and ``intersect_tris_pairs_shadow`` (the plain versions, on the CPU)
  against the JAX package's streamed kernel in interpret mode (n_st = 2,
  blk 256), under the Queue C per-cast standard: >= 99.9% of lanes agree
  on hit/miss, winner id and t within rtol 1e-5, and |dt| <= 1e-5 *
  max(t, 1) on every lane where both hit (XLA:CPU contracts the MT sums
  into FMAs, the port rounds each product; see tests/test_torch_pairs.py).
  The winner's Ng comes from the same field rows, so it is equal wherever
  the ids are;
- the JAX table converted with ``scene_tables_from_numpy`` gives the
  port's own table, and the same hits;
- a mesh past the port's slot ceiling (patched down) builds without
  pairs tables, with a warning, and renders through the tiled kernels.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.ops import pairs_trace as jpt
from raytracinggpu_tpu.scene.mesh import build_mesh as j_build_mesh
from raytracinggpu_tpu.scene.obj import ObjMesh as JObj
from raytracinggpu_tpu.scene.presets import wall_spheres as j_walls
from raytracinggpu_tpu.scene.scene import (
    build_scene_tables as j_build_scene_tables,
)
from raytracinggpu_tpu_torch import convert
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.integrator.wavefront import _effective_traversal
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.mesh import build_mesh, load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, ObjMesh
from raytracinggpu_tpu_torch.scene.presets import build_preset, wall_spheres
from raytracinggpu_tpu_torch.scene.scene import build_scene_tables

torch.set_num_threads(2)

EPS, SUBG, BLK = 1e-4, 16, 256
PAIRS_FIELDS = ("fields", "tile_aabb", "slot_src", "member_aabb",
                "member_tile", "member_slot")
N_SOUP = 34000


def _obj(cls, n=N_SOUP, seed=0):
    """The soup as an OBJ parse: three fresh vertices per triangle, no
    normals."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    B = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    C = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    V = np.concatenate([A, B, C], axis=0)
    vtx = np.arange(3 * n, dtype=np.int32).reshape(3, n).T.copy()
    none = np.full((n, 3), -1, np.int32)
    return cls(vertices=V, normals=np.zeros((0, 3), np.float32),
               uvs=np.zeros((0, 3), np.float32), vtx=vtx, nrm=none,
               uv=none.copy())


@pytest.fixture(scope="module")
def soup():
    """(JAX scene tables as numpy, the port's scene tables), both of the
    soup in the array_bvh walls, built once for the module."""
    spheres, mats = wall_spheres(990.0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the JAX bvh traversal's leaf note
        jtab = j_build_scene_tables(*j_walls(990.0), L=(-10, 20, 40),
                                    intensity=3e10,
                                    mesh=j_build_mesh(_obj(JObj)))
    ptab = build_scene_tables(spheres, mats, L=(-10, 20, 40), intensity=3e10,
                              mesh=build_mesh(_obj(ObjMesh)), device="cpu")
    return jax.tree.map(np.asarray, jtab), ptab


def _rays(m=256, seed=5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-25, 25, (3, m)).astype(np.float32)
    d = rng.standard_normal((3, m)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cap = rng.uniform(5, 50, m).astype(np.float32)
    return o, d, cap


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _pv(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _agree(ta, ia, tb, ib):
    """Fraction of lanes agreeing on hit/miss, winner id and t (rtol 1e-5
    where both hit); max of |dt| / max(t, 1) where both hit."""
    ha, hb = ta < 1e9, tb < 1e9
    both = ha & hb
    dt = np.where(both, np.abs(ta - tb), 0.0)
    same = (ha == hb) & (~ha | (ia == ib)) & (dt <= 1e-5 * np.abs(ta))
    return same.mean(), (dt / np.maximum(np.abs(ta), 1.0)).max()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("field", PAIRS_FIELDS)
def test_soup_tables_equal_the_jax_prefix(soup, field):
    jtab, ptab = soup
    j = np.asarray(getattr(jtab.pairs_mesh, field))
    p = getattr(ptab.pairs_mesh, field).numpy()
    nc = ptab.pairs_mesh.tile_aabb.shape[0]
    assert nc == 377
    if field == "fields":
        assert p.shape == (32, nc * 128)
        assert j.shape[1] > jpt.ST_SLOTS and j.shape[1] % jpt.ST_SLOTS == 0
        assert not j[:, p.shape[1]:].any()   # the supertile padding is zero
        j = j[:, :p.shape[1]]
    _same(p, j)


@pytest.mark.parametrize("query", ["closest", "shadow"])
def test_streamed_casts_match_jax_interpret(soup, query):
    jtab, ptab = soup
    o, d, cap = _rays()
    jpairs = jax.tree.map(jnp.asarray, jtab.pairs_mesh)
    tab = ptab.pairs_mesh
    if query == "closest":
        jh, jN = jpt.intersect_tris_pairs(_jv(o), _jv(d), jpairs, EPS,
                                          interpret=True, subg=SUBG, blk=BLK,
                                          payload="geom")
        ph, pN = ppt.intersect_tris_pairs(_pv(o), _pv(d), tab, EPS,
                                          subg=SUBG, blk=BLK, payload="geom")
        tj, ij = np.asarray(jh.t), np.asarray(jh.idx)
        tp, ip = ph.t.numpy(), ph.idx.numpy()
        same = (tj < 1e9) & (tp < 1e9) & (ij == ip)
        for a, b in zip(jN, pN):
            np.testing.assert_array_equal(b.numpy()[same],
                                          np.asarray(a)[same])
    else:
        tj = np.asarray(jpt.intersect_tris_pairs_shadow(
            _jv(o), _jv(d), jpairs, EPS, cap=jnp.asarray(cap),
            interpret=True, subg=SUBG, blk=BLK))
        tp = ppt.intersect_tris_pairs_shadow(
            _pv(o), _pv(d), tab, EPS, cap=torch.from_numpy(cap), subg=SUBG,
            blk=BLK).numpy()
        ij = ip = np.zeros(tj.shape, np.int32)
    frac, scaled = _agree(tj, ij, tp, ip)
    assert frac >= 0.999 and scaled <= 1e-5, (frac, scaled)
    assert (tp < 1e9).sum() > 30


def test_converted_streamed_table_runs_and_matches(soup):
    """The JAX table past ST_SLOTS, converted, is the port's own table
    (the supertile padding dropped) and gives the same hits."""
    jtab, ptab = soup
    conv = convert.scene_tables_from_numpy(jtab, "cpu")
    for f in PAIRS_FIELDS:
        assert torch.equal(getattr(conv.pairs_mesh, f),
                           getattr(ptab.pairs_mesh, f)), f
    o, d, cap = _rays(seed=9)
    outs = [ppt.intersect_tris_pairs(_pv(o), _pv(d), t.pairs_mesh, EPS,
                                     cap=torch.from_numpy(cap), subg=SUBG,
                                     blk=BLK, payload="geom")
            for t in (conv, ptab)]
    (h1, n1), (h2, n2) = outs
    assert torch.equal(h1.t, h2.t) and torch.equal(h1.idx, h2.idx)
    assert all(torch.equal(a, b) for a, b in zip(n1, n2))
    assert (h1.t < ppt.INF32).sum() > 10


def test_converted_table_with_a_nonzero_tail_raises(soup):
    jtab, _ = soup
    p = jtab.pairs_mesh
    fields = np.array(p.fields, copy=True)
    fields[3, -1] = 1.0
    bad = jtab._replace(pairs_mesh=p._replace(fields=fields))
    with pytest.raises(ValueError, match="nonzero columns"):
        convert.scene_tables_from_numpy(bad, "cpu")


def test_pairs_build_refuses_past_the_slot_ceiling(monkeypatch):
    """The ceiling is where the kernels' 32-bit field indices end; patched
    down, the cat's 40 tiles (5,120 slots) pass it."""
    assert ppt.MAX_SLOTS * ppt.NUM_FIELDS < 2**31
    assert (ppt.MAX_SLOTS + 1) * ppt.NUM_FIELDS >= 2**31
    cat = load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))
    assert ppt.build_pairs_tables(cat.A, cat.B, cat.C, cat.bvh,
                                  "cpu").fields.shape[1] == 5120
    monkeypatch.setattr(ppt, "MAX_SLOTS", 4096)
    with pytest.raises(ppt.PairsMeshTooLarge, match="32-bit"):
        ppt.build_pairs_tables(cat.A, cat.B, cat.C, cat.bvh, "cpu")


def test_pairs_fallback_past_the_ceiling(monkeypatch):
    """Past the ceiling the scene builds without pairs tables, warns, and
    traversal='pairs' renders through the tiled kernels: the same frame as
    traversal='pallas'."""
    size = dict(width=16, height=16, spp=1, max_depth=2)
    monkeypatch.setattr(ppt, "MAX_SLOTS", 4096)
    with pytest.warns(UserWarning, match="pairs kernel unavailable"):
        cfg, tables = build_preset("array_bvh", "cpu", **size)
    assert tables.pairs_mesh is None and tables.mesh is not None
    assert cfg.traversal == "pairs"
    assert _effective_traversal(cfg, tables) == "pallas"
    img, stats = render_preset_frame(tables, cfg, seed=0)
    assert np.isfinite(img).all()
    assert stats.hit.tolist() == [16 * 16] * 2
    monkeypatch.undo()
    pcfg, ptables = build_preset("array_bvh", "cpu", traversal="pallas",
                                 **size)
    np.testing.assert_array_equal(render_preset_frame(ptables, pcfg,
                                                      seed=0)[0], img)


def test_soup_obj_is_the_jax_text(tmp_path, monkeypatch):
    # importing the JAX benchmark points jax's compilation cache at the
    # repo unless the variable is set; empty keeps it off
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "")
    from raytracinggpu_tpu.bench.big_mesh import soup_obj as j_soup_obj
    from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj

    a, b = tmp_path / "port.obj", tmp_path / "jax.obj"
    soup_obj(str(a), 2000)
    j_soup_obj(str(b), 2000)
    text = a.read_bytes()
    assert text == b.read_bytes()
    assert text.count(b"\nf ") == 2000 and os.path.getsize(a) > 100_000
