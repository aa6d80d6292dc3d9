"""Rigid mesh poses rebuilt on the device (port of
``raytracinggpu_tpu/scene/transform.py``).

The reference builds a Y rotation for its realtime mesh and never
launches the vertex transform that would apply it.  Here a rigid
transform ``v -> M v + t`` poses the BVH-ordered base vertices that
``SceneTables.mesh_src`` keeps on the device and rebuilds every derived
mesh table from them with torch ops, on the scene's device:

- the Moller-Trumbore feature matrix and corner rows (``ops/triangle``),
  the tiled traversal's 16 field rows and tight tile boxes
  (``ops/pallas_trace``) and the pairs tables' 32 field rows, tile boxes
  and member boxes (``ops/pairs_trace``; member boxes by a segment min and
  max over the member id of each slot);
- the flat BVH's node boxes, refit conservatively by the interval form of
  the transformed box (exact containment under any affine map).

Rigid motion keeps every box containing its triangles once refit, so the
tree topology, the skip links, the leaf ranges and the slot maps are
reused unchanged.  The posed vertices round as XLA:CPU rounds the JAX
package's (each row of ``M v`` a fused ``dot``, ``core/vec``); the tables
built from them round every product and sum as the numpy host build does,
so an identity pose reproduces the host-built tables bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.vec import Vec3, cos, sin
from raytracinggpu_tpu_torch.ops.pairs_trace import (
    PairsMeshTables,
    fields_from_corners_torch,
    mt_rows,
    tile_width,
)
from raytracinggpu_tpu_torch.ops.pallas_trace import INF32, TILE_T
from raytracinggpu_tpu_torch.ops.triangle import TriTables


class MeshSource(NamedTuple):
    """BVH-ordered base geometry on the device, padded to the triangle
    tables' size Tp; ``valid`` masks the real triangles (padding stays
    all zeros under any pose)."""

    A: Vec3
    B: Vec3
    C: Vec3
    na: Vec3
    nb: Vec3
    nc: Vec3
    valid: torch.Tensor  # (Tp,) bool


def rotation_y(angle, device=None) -> torch.Tensor:
    """(3, 3) f32 Y-axis rotation, the pose the reference builds for its
    realtime mesh; ``angle`` a number or a 0-d tensor.  cos and sin are
    ``core/vec``'s (the f64 functions rounded to f32)."""
    a = torch.as_tensor(angle, dtype=torch.float32, device=device)
    c, s = cos(a), sin(a)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s]), torch.stack([z, o, z]),
                        torch.stack([-s, z, c])])


def _apply(M, t, v: Vec3, linear_only: bool = False) -> Vec3:
    """v -> M v (+ t), M's rows the output axes; each row a ``Vec3.dot``,
    rounded as XLA:CPU fuses the JAX package's sum of three products."""
    out = [Vec3(M[i, 0], M[i, 1], M[i, 2]).dot(v) for i in range(3)]
    if not linear_only:
        out = [o + t[i] for i, o in enumerate(out)]
    return Vec3(*out)


def _rows(v: Vec3) -> torch.Tensor:
    return torch.stack([v.x, v.y, v.z])


def _tri_tables(f, na: Vec3, nb: Vec3, nc: Vec3, old: TriTables) -> TriTables:
    """``ops/triangle.build_tri_tables`` from the posed corners' 16
    Moller-Trumbore rows ``f`` (``mt_rows``)."""
    ng, e2xa, e2, e1xa, e1 = (f[k:k + 3] for k in range(0, 15, 3))
    z = torch.zeros_like(ng)
    z1 = z[:1]
    # (10 ray features, 4 outputs, Tp): denom, beta, gamma, t numerators
    mt = torch.stack([torch.cat([ng, z, z, z1]),
                      torch.cat([e2xa, -e2, z, z1]),
                      torch.cat([-e1xa, e1, z, z1]),
                      torch.cat([z, z, -ng, f[15:16]])], dim=1)
    corners = torch.cat([_rows(na), _rows(nb), _rows(nc), ng, z, z1]
                        ).T.contiguous()
    return TriTables(mt=mt, ng=Vec3(*ng), na=na, nb=nb, nc=nc,
                     cornersT=corners, n_tri=old.n_tri)


def _box_rows(corners, live, n_boxes: int, width: int):
    """(n_boxes, 8) [mn.xyz, mx.xyz, 0, 0] of consecutive ``width``-wide
    groups of columns of the three (3, n) corner stacks, over the
    ``live`` columns only (an empty group gets mn = INF, mx = -INF)."""
    vals = torch.stack(corners)                          # (3 corners, 3, n)
    lo = torch.where(live, vals, INF32).reshape(3, 3, n_boxes, width)
    hi = torch.where(live, vals, -INF32).reshape(3, 3, n_boxes, width)
    mn = lo.amin(dim=(0, 3)).T
    mx = hi.amax(dim=(0, 3)).T
    return torch.cat([mn, mx, torch.zeros_like(mn[:, :2])], dim=1)


def _pairs_tables(a, b, c, old: PairsMeshTables, na: Vec3, nb: Vec3,
                  nc: Vec3) -> PairsMeshTables:
    """``ops/pairs_trace.build_pairs_tables`` from posed corners: the
    corners gathered per slot, the fields (the posed vertex normals in
    rows 17-25), tight tile boxes, and tight member boxes by a segment
    min/max over ``member_slot`` (the -1 padding goes to one extra
    segment, which is dropped)."""
    slot = old.slot_src
    f = fields_from_corners_torch(a, b, c, slot, _rows(na), _rows(nb),
                                  _rows(nc))
    live = slot >= 0
    idx = slot.clamp_min(0).long()
    per_slot = tuple(v[:, idx] for v in (a, b, c))       # (3, Tc) each
    nc_tiles = old.tile_aabb.shape[0]
    aabb = _box_rows(per_slot, live, nc_tiles, tile_width(old))

    nm = old.member_aabb.shape[0]
    seg = torch.where(old.member_slot >= 0, old.member_slot, nm).long()
    vals = torch.stack(per_slot)                         # (3, 3, Tc)
    lo = torch.where(live, vals, INF32).amin(dim=0)      # (3 axes, Tc)
    hi = torch.where(live, vals, -INF32).amax(dim=0)
    out = torch.zeros((3, nm + 1), dtype=lo.dtype, device=lo.device)
    seg3 = seg.expand(3, -1)
    m_mn = out.scatter_reduce(1, seg3, lo, "amin", include_self=False)[:, :nm]
    m_mx = out.scatter_reduce(1, seg3, hi, "amax", include_self=False)[:, :nm]
    m_aabb = torch.cat([m_mn.T, m_mx.T, torch.zeros((nm, 2), dtype=lo.dtype,
                                                    device=lo.device)], dim=1)
    return old._replace(fields=f, tile_aabb=aabb, member_aabb=m_aabb)


def _refit_boxes(mn: Vec3, mx: Vec3, M, t):
    """Conservative node boxes under an affine map: per output axis the
    min/max over the 8 transformed corners, in the interval form
    t_i + sum_j min/max(M_ij mn_j, M_ij mx_j)."""
    lo_c, hi_c = [], []
    for i in range(3):
        lo = torch.zeros_like(mn.x) + t[i]
        hi = torch.zeros_like(mn.x) + t[i]
        for j in range(3):
            p, q = M[i, j] * mn[j], M[i, j] * mx[j]
            lo = lo + torch.minimum(p, q)
            hi = hi + torch.maximum(p, q)
        lo_c.append(lo)
        hi_c.append(hi)
    return Vec3(*lo_c), Vec3(*hi_c)


def pose_mesh(scene, M, t=(0.0, 0.0, 0.0)):
    """A new SceneTables with the mesh rigidly transformed on the scene's
    device: v -> M v + t on the vertices, M alone on the vertex normals
    (a rotation keeps them unit), and every mesh table rebuilt.  The pairs
    tables are skipped when the build refused the mesh
    (``PairsMeshTooLarge``); the BVH keeps its topology and gets refit
    boxes.  M: (3, 3), t: (3,), numbers or tensors."""
    src: MeshSource | None = scene.mesh_src
    if src is None:
        raise ValueError("scene has no mesh to transform")
    dev = src.valid.device
    f32 = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.array(a, np.float32),
        dtype=torch.float32, device=dev)
    M, t = f32(M), f32(t)
    zero = lambda v: Vec3(*(torch.where(src.valid, c, 0.0) for c in v))
    A, B, C = (zero(_apply(M, t, v)) for v in (src.A, src.B, src.C))
    na, nb, nc = (zero(_apply(M, t, v, linear_only=True))
                  for v in (src.na, src.nb, src.nc))

    corners = tuple(_rows(v) for v in (A, B, C))
    f = mt_rows(*corners)
    mesh = _tri_tables(f, na, nb, nc, scene.mesh)
    old = scene.pallas_mesh
    pallas = old._replace(fields=f, fieldsT=f.T.contiguous(),
                          tile_aabb=_box_rows(corners, src.valid,
                                              old.n_tiles, TILE_T))
    pairs = scene.pairs_mesh
    if pairs is not None:
        pairs = _pairs_tables(*corners, pairs, na, nb, nc)
    bvh = scene.bvh
    if bvh is not None:
        mn, mx = _refit_boxes(bvh.mn, bvh.mx, M, t)
        bvh = bvh._replace(mn=mn, mx=mx)
    return scene._replace(mesh=mesh, pallas_mesh=pallas, pairs_mesh=pairs,
                          bvh=bvh)


def build_mesh_source(mesh, pad_to: int, device) -> MeshSource:
    """Host: the MeshData's BVH-ordered corners and vertex normals, padded
    to ``pad_to`` triangles, on ``device``."""
    T = mesh.n_tri

    def v(arr):
        a = np.pad(np.asarray(arr, np.float32), ((0, pad_to - T), (0, 0)))
        return Vec3(*(torch.from_numpy(a[:, k].copy()).to(device)
                      for k in range(3)))

    valid = np.zeros(pad_to, bool)
    valid[:T] = True
    return MeshSource(A=v(mesh.A), B=v(mesh.B), C=v(mesh.C), na=v(mesh.na),
                      nb=v(mesh.nb), nc=v(mesh.nc),
                      valid=torch.from_numpy(valid).to(device))
