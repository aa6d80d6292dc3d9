"""The port's clustering knobs of the pairs tables against the JAX
package's (raytracinggpu_tpu_torch/accel/sah.py, the ``pave`` packing and
``ids_map`` of ops/pairs_trace.py).

Both builders are the same numpy code, so the SAH tree (``order``
included) and every pairs table of every variant of
``tests/test_clustering.py::VARIANTS`` must be bitwise the JAX package's.
Within the port the cases of ``tests/test_clustering.py`` hold as there:
the SAH tree's invariants and quality, each variant's table invariants,
bit-identical renders across the variants (the closest hit's fold is a
lexicographic (t, id) min, so no clustering that covers every triangle
can change a frame), and boxes that contain the posed triangles under SAH
and pave.  The gallery case of that file is left out: this process must
not import ``raytracinggpu_tpu.bench.gallery`` (ROADMAP C3).
"""
import jax
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.accel.sah import build_sah_bvh as j_build_sah
from raytracinggpu_tpu.ops.pairs_trace import (
    build_pairs_tables as j_build_pairs,
)
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.accel.bvh import check_invariants, cluster_cut
from raytracinggpu_tpu_torch.accel.sah import build_sah_bvh
from raytracinggpu_tpu_torch.ops.pairs_trace import build_pairs_tables
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH
from raytracinggpu_tpu_torch.scene.presets import build_preset
from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y

torch.set_num_threads(2)

VARIANTS = {
    "base": dict(),
    "ref_cut32": dict(cut_tris=32),
    "ref_pave_c64": dict(pack="pave", cut_tris=64),
    "sah_pave_c32": dict(cluster="sah", pack="pave", cut_tris=32),
    "sah_morton": dict(cluster="sah"),
}
PAIRS_FIELDS = ("fields", "tile_aabb", "slot_src", "member_aabb",
                "member_tile", "member_slot")
TREE_FIELDS = ("left", "right", "mn", "mx", "tri_start", "tri_end", "skip",
               "order")


@pytest.fixture(scope="module")
def mesh():
    return load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _tables(mesh, builders, cluster="ref", **kw):
    """The pairs tables of one variant, by the port's (``builders`` =
    (build_sah_bvh, build_pairs_tables, extra args)) or the JAX package's
    code."""
    sah, pairs, extra = builders
    tree, ids = mesh.bvh, None
    if cluster == "sah":
        tree = sah(mesh.A, mesh.B, mesh.C)
        ids = tree.order
    return pairs(mesh.A, mesh.B, mesh.C, tree, *extra, ids_map=ids, **kw)


PORT = (build_sah_bvh, build_pairs_tables, ("cpu",))
JAX = (j_build_sah, j_build_pairs, ())


def test_sah_tree_bitwise_and_its_invariants(mesh):
    sah = build_sah_bvh(mesh.A, mesh.B, mesh.C, max_leaf=8)
    ref = j_build_sah(mesh.A, mesh.B, mesh.C, max_leaf=8)
    for f in TREE_FIELDS:
        _same(getattr(sah, f), getattr(ref, f))
    _same(sah.to_reference_layout(), ref.to_reference_layout())
    check_invariants(sah, mesh.A, mesh.B, mesh.C)
    assert ((sah.tri_end - sah.tri_start)[sah.right == -1]).max() <= 8

    def cut_cost(tree):
        # expected intersection cost sum(SA * N) over the cut clusters:
        # the granularity the cluster tree is used at
        cut = cluster_cut(tree, max_tris=32)
        d = np.maximum(cut.mx - cut.mn, 0.0)
        sa = d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]
        return float((sa * (cut.ends - cut.starts)).sum())

    assert cut_cost(sah) < cut_cost(mesh.bvh)


def test_check_invariants_catches_a_broken_tree(mesh):
    sah = build_sah_bvh(mesh.A, mesh.B, mesh.C)
    sah.skip[1] = 0    # an escape link that points backwards
    with pytest.raises(AssertionError):
        check_invariants(sah, mesh.A, mesh.B, mesh.C)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_tables_bitwise_the_jax_package(mesh, name):
    p = _tables(mesh, PORT, **VARIANTS[name])
    j = _tables(mesh, JAX, **VARIANTS[name])
    for f in PAIRS_FIELDS:
        _same(getattr(p, f).numpy(), getattr(j, f))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_table_invariants(mesh, name):
    tab = _tables(mesh, PORT, **VARIANTS[name])
    T = mesh.n_tri
    ss = tab.slot_src.numpy()
    cov = np.sort(ss[ss >= 0])
    assert cov.shape[0] == T and (cov == np.arange(T)).all(), (
        "slots must cover every triangle exactly once")
    tile_t = ss.shape[0] // tab.tile_aabb.shape[0]
    m_slot = tab.member_slot.numpy()
    m_tile = tab.member_tile.numpy()
    m_aabb = tab.member_aabb.numpy()
    assert (m_slot >= 0).sum() == T, "every triangle belongs to a member"
    for m in range(m_aabb.shape[0]):
        sel = np.nonzero(m_slot == m)[0]
        assert sel.size, f"member {m} has no slots"
        assert (sel // tile_t == m_tile[m]).all()
        ids = ss[sel]
        pts = np.concatenate([mesh.A[ids], mesh.B[ids], mesh.C[ids]])
        assert (pts.min(0) >= m_aabb[m, 0:3] - 1e-4).all()
        assert (pts.max(0) <= m_aabb[m, 3:6] + 1e-4).all()
    if VARIANTS[name].get("pack") == "pave":
        # 100% occupancy: padding only in the final tile
        assert (ss[: (T // tile_t) * tile_t] >= 0).all()


def test_unknown_packing_and_cluster_tree_are_refused(mesh):
    with pytest.raises(ValueError, match="packing"):
        build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh, "cpu",
                           pack="zigzag")
    with pytest.raises(ValueError, match="pairs_cluster"):
        build_preset("array_bvh", "cpu", mesh=mesh, width=8, height=8,
                     spp=1, max_depth=1, pairs_cluster="kd")


def _over(kw):
    return dict(pairs_cluster=kw.get("cluster", "ref"),
                pairs_cut=kw.get("cut_tris", 0),
                pairs_pack=kw.get("pack", "morton"))


def _frame(mesh, kw):
    cfg, tables = build_preset("array_bvh", "cpu", mesh=mesh, width=32,
                               height=32, spp=2, max_depth=2,
                               traversal="pairs", **_over(kw))
    return render_preset_frame(tables, cfg, seed=0)[0]


@pytest.fixture(scope="module")
def base_frame(mesh):
    img = _frame(mesh, VARIANTS["base"])
    assert np.isfinite(img).all()
    return img


@pytest.mark.parametrize("name", [n for n in VARIANTS if n != "base"])
def test_renders_bit_identical(mesh, base_frame, name):
    assert np.array_equal(_frame(mesh, VARIANTS[name]), base_frame), (
        f"clustering variant {name} changed the render")


def test_scene_build_carries_the_variant_as_the_jax_package(mesh):
    """build_preset(pairs_cluster="sah", pairs_pack="pave", pairs_cut=32)
    builds the same pairs tables in both packages."""
    over = _over(VARIANTS["sah_pave_c32"])
    _, jtab = j_build_preset("array_bvh", mesh=mesh, width=8, height=8,
                             spp=1, max_depth=1, **over)
    _, ptab = build_preset("array_bvh", "cpu", mesh=mesh, width=8,
                           height=8, spp=1, max_depth=1, **over)
    jp = jax.tree.map(np.asarray, jtab.pairs_mesh)
    for f in PAIRS_FIELDS:
        _same(getattr(ptab.pairs_mesh, f).numpy(), getattr(jp, f))


def test_pose_transform_with_sah_pave(mesh):
    """The pose refits member boxes by a segment reduction over the slot
    map; under SAH + pave (split members, full tiles, permuted slot ids)
    every posed vertex stays inside its member's box and its tile's."""
    _, tables = build_preset(
        "array_bvh", "cpu", mesh=mesh, width=48, height=48, spp=2,
        max_depth=2, traversal="pairs", **_over(VARIANTS["sah_pave_c32"]))
    ang = 0.7
    posed = pose_mesh(tables, rotation_y(ang))
    pm = posed.pairs_mesh
    slot_src = pm.slot_src.numpy()
    m_slot = pm.member_slot.numpy()
    aabb = pm.member_aabb.numpy()
    tiles = pm.tile_aabb.numpy()
    tile_t = slot_src.shape[0] // tiles.shape[0]
    src = tables.mesh_src
    c, s = np.cos(ang), np.sin(ang)
    Rm = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    live = slot_src >= 0
    for corner in (src.A, src.B, src.C):
        V = np.stack([v.numpy() for v in corner], axis=1) @ Rm.T
        pts = V[slot_src[live]]
        m = m_slot[live]
        j = np.nonzero(live)[0] // tile_t
        assert (pts >= aabb[m, 0:3] - 1e-3).all()
        assert (pts <= aabb[m, 3:6] + 1e-3).all()
        assert (pts >= tiles[j, 0:3] - 1e-3).all()
        assert (pts <= tiles[j, 3:6] + 1e-3).all()
