"""Wavefront OBJ ingestion (port of ``raytracinggpu_tpu/scene/obj.py``:
the numpy parser, or the native one of ``native.py``).

- ``v`` / ``vn`` / ``vt`` records parsed into float arrays,
- faces in any of the formats ``i``, ``i/j``, ``i//k``, ``i/j/k``,
- negative (relative) indices resolved against the current array size,
- polygons fan-triangulated as (v0, v_k, v_{k+1}) for k >= 2,
- optional embedded transform ``v -> v*0.8 + (0,-10,0)`` applied at load.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from raytracinggpu_tpu_torch import native as native_mod


@dataclass
class ObjMesh:
    """Raw parse result (host numpy, float32/int32)."""

    vertices: np.ndarray  # (V, 3) f32
    normals: np.ndarray   # (Nn, 3) f32
    uvs: np.ndarray       # (U, 3) f32 (z unused)
    # per-triangle index records, -1 where absent
    vtx: np.ndarray       # (T, 3) i32
    nrm: np.ndarray       # (T, 3) i32
    uv: np.ndarray        # (T, 3) i32
    group: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))


def _resolve(i: int, size: int) -> int:
    # negative indices are relative to the end
    return size + i if i < 0 else i - 1


def _parse_corner(tok: str, nv: int, nu: int, nn: int):
    """One face corner -> (vertex, uv, normal) indices (-1 if absent)."""
    parts = tok.split("/")
    v = _resolve(int(parts[0]), nv)
    u = n = -1
    if len(parts) >= 2 and parts[1] != "":
        u = _resolve(int(parts[1]), nu)
    if len(parts) >= 3 and parts[2] != "":
        n = _resolve(int(parts[2]), nn)
    return v, u, n


def read_obj(path: str | os.PathLike, embed_transform: bool = False,
             native: bool | None = None) -> ObjMesh:
    """Parse an OBJ file.

    embed_transform: apply ``v*0.8 + (0,-10,0)`` to vertices at load, the
    transform the reference hardcodes inside readOBJ for the cpu/global/
    optimized launchers.
    native: the C++ parser (``native.resolve``: False numpy, True the
    library or RuntimeError, None the library when it builds).  Its arrays
    are the numpy parser's bit for bit; it does not track usemtl groups
    (``group`` is all 0).
    """
    lib = native_mod.resolve(native)
    if lib is not None:
        vertices, normals, uvs, fv, fn, fu = native_mod.parse_obj(
            lib, os.fspath(path), embed_transform)
        return _validated(ObjMesh(
            vertices=vertices, normals=normals, uvs=uvs, vtx=fv, nrm=fn,
            uv=fu, group=np.zeros(len(fv), np.int32)), path)
    vertices: list[tuple] = []
    normals: list[tuple] = []
    uvs: list[tuple] = []
    fv: list[tuple] = []
    fn: list[tuple] = []
    fu: list[tuple] = []
    fg: list[int] = []
    cur_group = -1

    with open(path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tokens = line.split()
            tag = tokens[0]
            if tag == "usemtl":
                cur_group += 1
            elif tag == "v":
                x, y, z = float(tokens[1]), float(tokens[2]), float(tokens[3])
                if embed_transform:
                    x, y, z = x * 0.8, y * 0.8 - 10.0, z * 0.8
                vertices.append((x, y, z))
            elif tag == "vn":
                normals.append((float(tokens[1]), float(tokens[2]), float(tokens[3])))
            elif tag == "vt":
                u = float(tokens[1])
                v = float(tokens[2]) if len(tokens) > 2 else 0.0
                uvs.append((u, v, 0.0))
            elif tag == "f":
                nv, nu, nn = len(vertices), len(uvs), len(normals)
                corners = [
                    _parse_corner(t, nv, nu, nn) for t in tokens[1:] if t
                ]
                # fan triangulation (v0, v_k, v_{k+1})
                for k in range(1, len(corners) - 1):
                    a, b, c = corners[0], corners[k], corners[k + 1]
                    fv.append((a[0], b[0], c[0]))
                    fu.append((a[1], b[1], c[1]))
                    fn.append((a[2], b[2], c[2]))
                    fg.append(cur_group)

    def arr(lst, dtype, width=3):
        if not lst:
            return np.zeros((0, width), dtype)
        return np.asarray(lst, dtype)

    return _validated(ObjMesh(
        vertices=arr(vertices, np.float32),
        normals=arr(normals, np.float32),
        uvs=arr(uvs, np.float32),
        vtx=arr(fv, np.int32),
        nrm=arr(fn, np.int32),
        uv=arr(fu, np.int32),
        group=np.asarray(fg, np.int32),
    ), path)


def _validated(mesh: ObjMesh, path) -> ObjMesh:
    """Index-range validation.  OBJ indices are 1-based; a literal ``0``
    resolves to -1, which numpy fancy indexing would silently wrap to the
    last vertex — raise instead.  Normal/uv slots keep -1 as the 'absent'
    sentinel, so only over-range values are rejected there."""
    nv = mesh.vertices.shape[0]
    if mesh.vtx.size and (
            (mesh.vtx < 0).any() or (mesh.vtx >= nv).any()):
        raise ValueError(
            f"invalid OBJ {path!s}: face vertex index out of range "
            f"(OBJ indices are 1-based; 0 is illegal)")
    for name, idx, size in (("normal", mesh.nrm, mesh.normals.shape[0]),
                            ("uv", mesh.uv, mesh.uvs.shape[0])):
        if idx.size and ((idx < -1).any() or (idx >= size).any()):
            raise ValueError(
                f"invalid OBJ {path!s}: face {name} index out of range")
    return mesh


# The cat mesh lives in the JAX package's asset folder of a repo checkout;
# it is located by file path (importing that package would pull in jax).
# RT_CAT_OBJ points at another copy.
CAT_OBJ_PATH = os.environ.get(
    "RT_CAT_OBJ",
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))),
        "raytracinggpu_tpu",
        "assets",
        "cat.obj",
    ),
)
