"""The port's Morton LBVH builder and the mesh build it feeds, against the
JAX package's (raytracinggpu_tpu_torch/accel/lbvh.py, scene/mesh.py).

Both builders are the same numpy code, so every FlatBVH array must be
bitwise equal, on the cat and on a 5,000-triangle soup; the port's tree
must also keep the invariants ``tests/test_lbvh.py`` checks (the JAX
package's ``check_invariants``), and both builders must give the same
closest hits.
"""
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.accel.bvh import check_invariants
from raytracinggpu_tpu.accel.lbvh import build_lbvh as j_build_lbvh
from raytracinggpu_tpu.scene.mesh import build_mesh as j_build_mesh
from raytracinggpu_tpu.scene.obj import read_obj as j_read_obj
from raytracinggpu_tpu_torch.accel.lbvh import build_lbvh, morton_codes
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pallas_trace import (
    INF32,
    build_pallas_tables,
    intersect_tris_pallas,
)
from raytracinggpu_tpu_torch.scene.mesh import build_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj

torch.set_num_threads(2)

BVH_FIELDS = ("left", "right", "mn", "mx", "tri_start", "tri_end", "order",
              "skip")


def _corners(obj):
    return tuple(obj.vertices[obj.vtx[:, k]] for k in range(3))


def _soup(n=5000, seed=3):
    """Small random triangles through a box, as tests/test_big_mesh.py
    makes them."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-20, 20, (n, 3)).astype(np.float32)
    B = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    C = A + rng.standard_normal((n, 3)).astype(np.float32) * 0.5
    return A, B, C


@pytest.fixture(scope="module")
def cat():
    return _corners(read_obj(CAT_OBJ_PATH))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("mesh", ["cat", "soup"])
def test_lbvh_bitwise(cat, mesh):
    A, B, C = cat if mesh == "cat" else _soup()
    a, b = build_lbvh(A, B, C), j_build_lbvh(A, B, C)
    for f in BVH_FIELDS:
        _same(getattr(a, f), getattr(b, f))
    assert a.n_nodes > A.shape[0] // 8


def test_morton_ordering_groups_nearby_points():
    pts = np.array([[0, 0, 0], [0.01, 0, 0], [1, 1, 1], [0.99, 1, 1]],
                   np.float32)
    pos = np.empty(4, int)
    pos[np.argsort(morton_codes(pts), kind="stable")] = np.arange(4)
    assert abs(pos[0] - pos[1]) == 1 and abs(pos[2] - pos[3]) == 1


def test_lbvh_invariants_random(rng):
    A = (rng.random((300, 3)) * 10).astype(np.float32)
    B = A + rng.standard_normal((300, 3)).astype(np.float32)
    C = A + rng.standard_normal((300, 3)).astype(np.float32)
    check_invariants(build_lbvh(A, B, C), A, B, C)


def test_lbvh_invariants_cat(cat):
    bvh = build_lbvh(*cat)
    check_invariants(bvh, *cat)
    leaves = bvh.right == -1
    # Morton splits always bisect: no degenerate giant leaves
    assert (bvh.tri_end - bvh.tri_start)[leaves].max() <= 8


@pytest.mark.parametrize("builder", ["reference", "lbvh"])
def test_build_mesh_bitwise(builder):
    """build_mesh(builder=...) gives the JAX package's MeshData: corners
    and normals in BVH order, and the vertex and normal counts."""
    a = build_mesh(read_obj(CAT_OBJ_PATH), builder=builder)
    b = j_build_mesh(j_read_obj(CAT_OBJ_PATH, native=False), builder=builder)
    for f in ("A", "B", "C", "na", "nb", "nc"):
        _same(getattr(a, f), getattr(b, f))
    for f in BVH_FIELDS:
        _same(getattr(a.bvh, f), getattr(b.bvh, f))
    assert (a.n_vertices, a.n_normals) == (b.n_vertices, b.n_normals)
    assert a.n_normals > 0 and a.n_vertices > 0


def test_unknown_builder_raises():
    with pytest.raises(ValueError, match="builder"):
        build_mesh(read_obj(CAT_OBJ_PATH), builder="sah")


def test_lbvh_hit_parity_with_reference_builder():
    """Same mesh, both builders, the tiled traversal: the same hits."""
    obj = read_obj(CAT_OBJ_PATH)
    hits = []
    rng = np.random.default_rng(1234)
    o = rng.uniform(-25, 25, (256, 3)).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    O = Vec3(*(torch.from_numpy(o[:, i].copy()) for i in range(3)))
    u = Vec3(*(torch.from_numpy(d[:, i].copy()) for i in range(3)))
    for builder in ("reference", "lbvh"):
        m = build_mesh(obj, builder=builder)
        tab = build_pallas_tables(m.A, m.B, m.C, "cpu")
        hits.append(intersect_tris_pallas(O, u, tab, 1e-4).t.numpy())
    t_r, t_l = hits
    np.testing.assert_array_equal(t_r < INF32, t_l < INF32)
    hit = t_r < INF32
    assert hit.sum() > 10
    np.testing.assert_allclose(t_r[hit], t_l[hit], rtol=1e-5, atol=1e-5)
