"""Triangle mesh assembly: OBJ -> transforms -> BVH -> BVH-ordered corners
(port of ``raytracinggpu_tpu/scene/mesh.py``).

The host dereferences the face indices once into per-triangle corner
arrays (A, B, C) in BVH leaf order, so the device tables need no index
indirection.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from raytracinggpu_tpu_torch.accel.bvh import FlatBVH, build_bvh
from raytracinggpu_tpu_torch.accel.lbvh import build_lbvh
from raytracinggpu_tpu_torch.scene.obj import ObjMesh, read_obj
from raytracinggpu_tpu_torch.utils.profiling import build_count, build_span

BUILDERS = {"reference": build_bvh, "lbvh": build_lbvh}


def rescale(vertices: np.ndarray, scale: float, offset) -> np.ndarray:
    """v -> v*scale + offset."""
    return (vertices * np.float32(scale) + np.asarray(offset, np.float32)).astype(
        np.float32
    )


def rotate_y(vertices: np.ndarray, angle: float) -> np.ndarray:
    """Host Y-axis rotation of (V, 3) vertices, the matrix the reference
    builds for its mesh pose, in f32."""
    c, s = np.cos(angle, dtype=np.float32), np.sin(angle, dtype=np.float32)
    m = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return (vertices @ m.T).astype(np.float32)


@dataclass
class MeshData:
    """Host-side mesh in BVH (leaf) triangle order."""

    A: np.ndarray  # (T, 3) first corner, BVH order
    B: np.ndarray
    C: np.ndarray
    na: np.ndarray  # (T, 3) per-corner vertex normals (zeros when absent)
    nb: np.ndarray
    nc: np.ndarray
    bvh: FlatBVH
    n_vertices: int
    n_normals: int

    @property
    def n_tri(self) -> int:
        return self.A.shape[0]


def build_mesh(obj: ObjMesh, builder: str = "reference") -> MeshData:
    """Dereference indices, build the BVH over the triangle soup, and
    reorder the per-triangle tables into BVH leaf order.

    builder: "reference" (the midpoint split, the reference's semantics)
    or "lbvh" (Morton-code linear BVH); both emit the same flat layout.
    The builder's work is the span ``build.bvh`` (its attribute the
    triangles), and the triangles the counter ``mesh.triangles``."""
    if builder not in BUILDERS:
        raise ValueError(f"unknown BVH builder {builder!r}; choose from "
                         f"{tuple(BUILDERS)}")
    V = obj.vertices
    A = V[obj.vtx[:, 0]]
    B = V[obj.vtx[:, 1]]
    C = V[obj.vtx[:, 2]]
    with build_span("build.bvh", A.shape[0]):
        bvh = BUILDERS[builder](A, B, C)
    build_count("mesh.triangles", A.shape[0])
    o = bvh.order

    has_n = obj.normals.shape[0] > 0 and (obj.nrm >= 0).all()
    if has_n:
        na = obj.normals[obj.nrm[:, 0]]
        nb = obj.normals[obj.nrm[:, 1]]
        nc = obj.normals[obj.nrm[:, 2]]
    else:
        na = nb = nc = np.zeros_like(A)

    return MeshData(
        A=A[o].copy(),
        B=B[o].copy(),
        C=C[o].copy(),
        na=na[o].copy(),
        nb=nb[o].copy(),
        nc=nc[o].copy(),
        bvh=bvh,
        n_vertices=V.shape[0],
        n_normals=obj.normals.shape[0],
    )


def load_cat_mesh(path: str, embed_transform: bool, scale: float | None,
                  offset, builder: str = "reference") -> MeshData:
    """Load + transform the cat mesh per launcher config
    (array_bvh and realtime: rescale(0.6, (0,-10,0)) only); the parse
    and the placement are the span ``build.obj``."""
    with build_span("build.obj"):
        obj = read_obj(path, embed_transform=embed_transform)
        if scale is not None:
            obj.vertices = rescale(obj.vertices, scale, offset)
    return build_mesh(obj, builder=builder)
