"""The port's host scene build against the JAX package's
(raytracinggpu_tpu_torch/scene, accel, ops/pairs_trace host half).

Both builders are the same numpy code, so every array of the
``array_bvh`` tables must be bitwise equal: the OBJ parse, the reference
midpoint BVH, the cluster-packed pairs tables, spheres, materials and the
light.  ``scene_tables_from_numpy`` must carry the JAX tables across
bit for bit.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.accel.bvh import build_bvh as j_build_bvh
from raytracinggpu_tpu.accel.lbvh import morton_codes as j_morton
from raytracinggpu_tpu.scene.obj import CAT_OBJ_PATH as J_CAT
from raytracinggpu_tpu.scene.obj import read_obj as j_read_obj
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.accel.bvh import build_bvh, cluster_cut
from raytracinggpu_tpu_torch.accel.lbvh import morton_codes
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
from raytracinggpu_tpu_torch.scene.presets import (
    PRESET_NAMES,
    build_preset,
    make_config,
)

torch.set_num_threads(2)

PAIRS_FIELDS = ("fields", "tile_aabb", "slot_src", "member_aabb",
                "member_tile", "member_slot")


@pytest.fixture(scope="module")
def both():
    jcfg, jtab = j_build_preset("array_bvh", traversal="pairs")
    pcfg, ptab = build_preset("array_bvh", "cpu")
    return jcfg, jax.tree.map(np.asarray, jtab), pcfg, ptab


def _same(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_cat_path_and_obj_parse():
    assert CAT_OBJ_PATH == J_CAT
    a, b = read_obj(CAT_OBJ_PATH), j_read_obj(J_CAT, native=False)
    for f in ("vertices", "normals", "uvs", "vtx", "nrm", "uv", "group"):
        _same(getattr(a, f), getattr(b, f))


def test_bvh_and_cluster_cut_bitwise(cat_mesh_raw):
    V = cat_mesh_raw.vertices * np.float32(0.6) + np.float32([0, -10, 0])
    A, B, C = (V[cat_mesh_raw.vtx[:, k]] for k in range(3))
    a, b = build_bvh(A, B, C), j_build_bvh(A, B, C, native=False)
    for f in ("left", "right", "mn", "mx", "tri_start", "tri_end", "skip"):
        _same(getattr(a, f), getattr(b, f))
    np.testing.assert_array_equal(a.order, b.order)
    from raytracinggpu_tpu.accel.bvh import cluster_cut as j_cut

    ca, cb = cluster_cut(a, 128), j_cut(b, 128)
    for f in ("starts", "ends", "mn", "mx"):
        _same(getattr(ca, f), getattr(cb, f))
    pts = np.random.default_rng(0).normal(size=(500, 3)).astype(np.float32)
    _same(morton_codes(pts), j_morton(pts))


@pytest.mark.parametrize("field", PAIRS_FIELDS)
def test_pairs_tables_bitwise(both, field):
    _, jtab, _, ptab = both
    _same(getattr(ptab.pairs_mesh, field).numpy(),
          getattr(jtab.pairs_mesh, field))


def test_cat_pairs_table_sizes(both):
    """The cat packs into 40 tiles of 128 slots (W = 2 bitmask words) with
    62 member boxes."""
    _, _, _, ptab = both
    assert tuple(ptab.pairs_mesh.fields.shape) == (32, 40 * 128)
    assert ptab.pairs_mesh.member_aabb.shape[0] == 62


def test_spheres_materials_light_bitwise(both):
    _, jtab, _, ptab = both
    for f in ("cx", "cy", "cz", "radius"):
        _same(getattr(ptab.spheres, f).numpy(), getattr(jtab.spheres, f))
    for c in range(3):
        _same(ptab.materials.albedo[c].numpy(), jtab.materials.albedo[c])
        _same(ptab.L[c].numpy(), jtab.L[c])
    for f in ("mirror", "in_ri", "out_ri"):
        _same(getattr(ptab.materials, f).numpy(),
              getattr(jtab.materials, f))
    _same(ptab.intensity.numpy(), jtab.intensity)


def test_config_and_autotuned_subgroup(both):
    jcfg, _, pcfg, _ = both
    assert pcfg.pairs_subgroup == jcfg.pairs_subgroup == 64
    conv = render_config_from_dict(dataclasses.asdict(jcfg))
    assert conv == pcfg
    for name in PRESET_NAMES:
        j = dataclasses.asdict(
            __import__("raytracinggpu_tpu.scene.presets", fromlist=["x"])
            .make_config(name))
        assert render_config_from_dict(j) == make_config(name)
    rt = make_config("realtime")
    assert (rt.smooth_normals, rt.camera_point_quirk, rt.spp,
            rt.max_depth, rt.eps_leaf) == (True, True, 20, 3, 1e-3)


@pytest.mark.parametrize("nc", [40, 128, 129, 1023, 1024, 2053])
@pytest.mark.parametrize("overrides", [{}, {"pairs_subgroup": 32},
                                       {"pairs_key_coarse": 4}])
def test_autotune_pairs_is_the_jax_rule(nc, overrides):
    """Subgroup 16 past 128 tiles and a key over 32-tile unions from 1,024
    tiles, each unless the caller set it: the JAX package's rule."""
    from types import SimpleNamespace

    from raytracinggpu_tpu.scene.presets import _autotune_pairs as j_auto
    from raytracinggpu_tpu.scene.scene import RenderConfig as JCfg
    from raytracinggpu_tpu_torch.scene.presets import _autotune_pairs
    from raytracinggpu_tpu_torch.scene.scene import RenderConfig

    tables = SimpleNamespace(pairs_mesh=SimpleNamespace(
        tile_aabb=np.zeros((nc, 8), np.float32)))
    got = _autotune_pairs(RenderConfig(**overrides), tables, overrides)
    want = j_auto(JCfg(**overrides), tables, overrides)
    knobs = ("pairs_subgroup", "pairs_key_coarse")
    assert [getattr(got, k) for k in knobs] == [getattr(want, k)
                                                for k in knobs]
    assert got.pairs_key_coarse == overrides.get(
        "pairs_key_coarse", 32 if nc >= 1024 else 1)


def test_unported_presets_raise():
    """No preset of the JAX package is left unported (the four that used
    to raise build: tests/test_torch_presets.py holds their tables); a name
    that is no preset raises."""
    from raytracinggpu_tpu.scene.presets import PRESET_NAMES as J_NAMES

    assert PRESET_NAMES == J_NAMES
    cfg, tab = build_preset("showcase", "cpu")
    assert tab.mesh is None and cfg.mesh_object_id == -1
    for name in ("cpu", "global", "optimized"):
        assert make_config(name).name == name
    with pytest.raises(ValueError, match="unknown preset"):
        build_preset("cornell", "cpu")


def test_realtime_tables_bitwise():
    """The realtime scene: the floor of radius 940, the light at
    (0, 15, 40), the same cat tables (vertex normals in rows 17-25)."""
    jcfg, jtab = j_build_preset("realtime", traversal="pairs")
    jtab = jax.tree.map(np.asarray, jtab)
    pcfg, ptab = build_preset("realtime", "cpu")
    assert render_config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    for f in ("cx", "cy", "cz", "radius"):
        _same(getattr(ptab.spheres, f).numpy(), getattr(jtab.spheres, f))
    for c in range(3):
        _same(ptab.L[c].numpy(), jtab.L[c])
    assert float(ptab.spheres.radius[1]) == 940.0
    assert [float(c) for c in ptab.L] == [0.0, 15.0, 40.0]
    _same(ptab.pairs_mesh.fields.numpy(), jtab.pairs_mesh.fields)
    assert (ptab.pairs_mesh.fields[17:26] != 0).any()


def test_mesh_without_normals_falls_back_to_geometric_normals():
    from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh

    mesh = load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))
    z = np.zeros_like(mesh.na)
    bare = dataclasses.replace(mesh, na=z, nb=z, nc=z)
    with pytest.warns(UserWarning, match="no vertex normals"):
        cfg, _ = build_preset("realtime", "cpu", mesh=bare)
    assert not cfg.smooth_normals and cfg.camera_point_quirk
    assert build_preset("realtime", "cpu", mesh=mesh)[0].smooth_normals


def test_convert_roundtrip_bitwise(both):
    _, jtab, _, ptab = both
    conv = scene_tables_from_numpy(jtab, "cpu")
    for f in PAIRS_FIELDS:
        assert torch.equal(getattr(conv.pairs_mesh, f),
                           getattr(ptab.pairs_mesh, f))
    for a, b in zip(conv.spheres, ptab.spheres):
        assert torch.equal(a, b)
    for a, b in zip(conv.materials.albedo, ptab.materials.albedo):
        assert torch.equal(a, b)
    for f in ("mirror", "in_ri", "out_ri"):
        assert torch.equal(getattr(conv.materials, f),
                           getattr(ptab.materials, f))
    for a, b in zip(conv.L, ptab.L):
        assert torch.equal(a, b)
    assert torch.equal(conv.intensity, ptab.intensity)


def test_bvh_and_mesh_source_bitwise(both):
    """The flat-BVH tables and the posing base geometry: the port's build
    and the converted JAX tables equal the JAX package's bit for bit."""
    _, jtab, _, ptab = both
    conv = scene_tables_from_numpy(jtab, "cpu")
    for tab in (ptab, conv):
        for f in ("left", "right", "tri_start", "tri_end", "skip"):
            _same(getattr(tab.bvh, f).numpy(), getattr(jtab.bvh, f))
        for k in range(3):
            _same(tab.bvh.mn[k].numpy(), jtab.bvh.mn[k])
            _same(tab.bvh.mx[k].numpy(), jtab.bvh.mx[k])
        for f in ("A", "B", "C", "na", "nb", "nc"):
            for k in range(3):
                _same(getattr(tab.mesh_src, f)[k].numpy(),
                      getattr(jtab.mesh_src, f)[k])
        _same(tab.mesh_src.valid.numpy(), jtab.mesh_src.valid)


@pytest.mark.parametrize("traversal", ["bvh", "pairs"])
def test_converted_tables_render_as_the_ports_own(traversal):
    """A JAX scene with ``bvh`` and ``mesh_src`` converts, and the port's
    frame from it equals the port's frame from its own build bit for bit,
    unposed and posed."""
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
    from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y

    size = dict(width=16, height=16, spp=1, max_depth=2,
                traversal=traversal)
    _, jtab = j_build_preset("array_bvh", **size)
    conv = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    cfg, own = build_preset("array_bvh", "cpu", **size)
    for a, b in ((conv, own), (pose_mesh(conv, rotation_y(0.9)),
                               pose_mesh(own, rotation_y(0.9)))):
        assert np.array_equal(render_preset_frame(a, cfg)[0],
                              render_preset_frame(b, cfg)[0])
