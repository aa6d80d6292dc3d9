"""Carry the JAX package's host tables and config across to the port.

``scene_tables_from_numpy`` takes the JAX ``SceneTables`` with every leaf
converted to numpy (``jax.tree.map(np.asarray, tables)``) and returns the
port's ``SceneTables`` on ``device``, so both packages compute on
identical tables (a mesh-less table, the ``showcase`` preset's, converts
to one without mesh tables; a mesh table brings its flat BVH and its base
geometry for posing).  ``render_config_from_dict`` does the same for a
``dataclasses.asdict`` of the JAX ``RenderConfig``, and
``render_state_from_numpy`` for the realtime loop's ``RenderState``.  All
read fields by name and import neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.rng import Key
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pairs_trace import PairsMeshTables
from raytracinggpu_tpu_torch.ops.pallas_trace import PallasMeshTables
from raytracinggpu_tpu_torch.ops.sphere import SphereTable
from raytracinggpu_tpu_torch.ops.triangle import TriTables
from raytracinggpu_tpu_torch.render.realtime import RenderState
from raytracinggpu_tpu_torch.scene.scene import (
    BVHTables,
    Materials,
    RenderConfig,
    SceneTables,
)
from raytracinggpu_tpu_torch.scene.transform import MeshSource


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _pairs_arrays(p):
    """The JAX pairs table's arrays in ``PairsMeshTables`` order, with
    the supertile padding dropped: the JAX package pads ``fields`` past
    ST_SLOTS (32,768) slots with zero columns up to whole ST_SLOTS blocks
    for its TPU kernel; the port's tables hold exactly nc * tile_t slots.
    Raises ValueError if a dropped column is not zero."""
    arrays = [np.asarray(getattr(p, f)) for f in PairsMeshTables._fields]
    fields, tile_aabb, slot_src = arrays[:3]
    nc = tile_aabb.shape[0]
    Tc = nc * (slot_src.shape[0] // nc)
    if np.any(fields[:, Tc:]):
        raise ValueError(f"the pairs fields hold nonzero columns past the "
                         f"{Tc} slots of their {nc} tiles")
    arrays[0] = fields[:, :Tc]
    return arrays


def scene_tables_from_numpy(tables_np, device) -> SceneTables:
    """The JAX package's SceneTables (numpy leaves) -> the port's.  A JAX
    table without pairs tables (its pairs build refused the mesh) gives a
    port table without them, and ``traversal="pairs"`` then runs as
    ``pallas``.  The pairs fields lose their supertile padding
    (``_pairs_arrays``)."""
    s, m = tables_np.spheres, tables_np.materials
    t = lambda a: _t(a, device)
    v = lambda a: Vec3(t(a.x), t(a.y), t(a.z))
    tri = pallas = pairs = bvh = src = None
    if tables_np.mesh is not None:
        d = tables_np.mesh
        tri = TriTables(mt=t(d.mt), ng=v(d.ng), na=v(d.na), nb=v(d.nb),
                        nc=v(d.nc), cornersT=t(d.cornersT),
                        n_tri=int(d.n_tri))
    if tables_np.pallas_mesh is not None:
        p = tables_np.pallas_mesh
        pallas = PallasMeshTables(fields=t(p.fields), fieldsT=t(p.fieldsT),
                                  tile_aabb=t(p.tile_aabb),
                                  n_tiles=int(p.n_tiles))
    if tables_np.pairs_mesh is not None:
        pairs = PairsMeshTables(*(t(a) for a in
                                  _pairs_arrays(tables_np.pairs_mesh)))
    if tables_np.bvh is not None:
        b = tables_np.bvh
        bvh = BVHTables(left=t(b.left), right=t(b.right),
                        tri_start=t(b.tri_start), tri_end=t(b.tri_end),
                        skip=t(b.skip), mn=v(b.mn), mx=v(b.mx))
    if tables_np.mesh_src is not None:
        ms = tables_np.mesh_src
        src = MeshSource(*(v(getattr(ms, k)) for k in
                           ("A", "B", "C", "na", "nb", "nc")),
                         valid=t(ms.valid))
    return SceneTables(
        spheres=SphereTable(t(s.cx), t(s.cy), t(s.cz), t(s.radius)),
        materials=Materials(albedo=v(m.albedo), mirror=t(m.mirror),
                            in_ri=t(m.in_ri), out_ri=t(m.out_ri)),
        mesh=tri,
        pallas_mesh=pallas,
        pairs_mesh=pairs,
        L=v(tables_np.L),
        intensity=t(tables_np.intensity),
        bvh=bvh,
        mesh_src=src,
    )


def render_config_from_dict(d: dict) -> RenderConfig:
    """The port's RenderConfig from the fields of ``d`` it has; the JAX
    package's other fields (its TPU tuning knobs) are dropped, and so are
    its ``pairs_chunk``, the TPU's bound on a cast, and its ``spp_fuse``,
    the samples of its wavefronts: the port sizes its pairs casts and
    groups its samples itself (``render/pipeline.pairs_cast_width``,
    ``group_size``; the frame does not depend on either)."""
    names = {f.name for f in dataclasses.fields(RenderConfig)} - {
        "pairs_chunk", "spp_fuse"}
    kw = {k: v for k, v in d.items() if k in names}
    if "camera_c" in kw:
        kw["camera_c"] = tuple(kw["camera_c"])
    return RenderConfig(**kw)


def render_state_from_numpy(state_np, device) -> RenderState:
    """The JAX package's realtime RenderState (numpy leaves: ``cam_c`` with
    x/y/z, ``key`` the (2,) uint32 threefry key) -> the port's, on
    ``device``."""
    t = lambda a: _t(a, device)
    key = np.asarray(state_np.key, np.uint32)
    return RenderState(
        accum=t(state_np.accum), frames=t(state_np.frames),
        rng_frame=t(state_np.rng_frame), light_angle=t(state_np.light_angle),
        mesh_angle=t(state_np.mesh_angle),
        cam_c=Vec3(t(state_np.cam_c.x), t(state_np.cam_c.y),
                   t(state_np.cam_c.z)),
        yaw=t(state_np.yaw), pitch=t(state_np.pitch),
        key=Key(*(torch.tensor(int(k), dtype=torch.int64, device=device)
                  for k in key)),
    )
