"""Scene device tables and static render configuration (port of
``raytracinggpu_tpu/scene/scene.py``).

Typed SoA tables -- one sphere table, the mesh's triangle, tiled and
pairs tables -- plus a materials table indexed by object id: spheres
0..S-1, then the mesh at id S, the reference's insertion order.  The bvh
tables of the JAX package are not ported yet.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pairs_trace import (
    PairsMeshTables,
    PairsMeshTooLarge,
    build_pairs_tables,
)
from raytracinggpu_tpu_torch.ops.pallas_trace import (
    PallasMeshTables,
    build_pallas_tables,
)
from raytracinggpu_tpu_torch.ops.sphere import SphereTable
from raytracinggpu_tpu_torch.ops.triangle import TriTables, build_tri_tables
from raytracinggpu_tpu_torch.scene.mesh import MeshData


class Materials(NamedTuple):
    """Per-object material columns, indexed by object id."""

    albedo: Vec3          # (M,)
    mirror: torch.Tensor  # (M,) bool
    in_ri: torch.Tensor   # (M,)
    out_ri: torch.Tensor  # (M,)


class SceneTables(NamedTuple):
    """Everything the integrator needs on the device."""

    spheres: SphereTable
    materials: Materials
    mesh: TriTables | None                # None: the scene has no mesh
    pallas_mesh: PallasMeshTables | None  # the tiled traversal's tables
    pairs_mesh: PairsMeshTables | None    # None with a mesh: pairs runs
                                          # as pallas (the pairs build
                                          # refused the mesh)
    L: Vec3       # point light position (0-d components)
    intensity: Any  # light intensity (0-d f32)

    @property
    def device(self) -> torch.device:
        return self.spheres.cx.device


TRAVERSALS = ("pairs", "pallas", "dense")


@dataclass(frozen=True)
class RenderConfig:
    """Static parameters of one render: the fields of the JAX package's
    ``RenderConfig`` that the ported paths read, with its defaults.  The
    mesh is never animated and the ``bvh`` traversal is not ported;
    ``convert.render_config_from_dict`` rejects a JAX config that asks for
    either."""

    name: str = "global"
    width: int = 512
    height: int = 512
    spp: int = 32
    max_depth: int = 5          # CLI <num_bounces>
    sigma: float = 0.2          # AA jitter
    eps_bounce: float = 1e-4    # bounce offset
    eps_leaf: float = 1e-4      # mesh leaf t epsilon
    fov: float = float(np.pi / 3)
    camera_c: tuple = (0.0, 0.0, 55.0)
    smooth_normals: bool = False   # realtime: Phong-interpolated mesh normals
    camera_point_quirk: bool = False  # realtime: cam.C added into the ray
                                      # direction (see pipeline.raygen)
    n_objects: int = 7          # spheres, plus the mesh when there is one
    mesh_object_id: int = 6     # -1 when the scene has no mesh
    traversal: str = "pairs"    # pairs (production) | pallas (tiled
                                # kernel) | dense (matrix-product oracle)
    ray_sort: bool = False      # pallas: sort rays into beam families
    ray_chunk: int = 65536      # dense: rays per cast
    spp_fuse: int = 4           # samples folded into one wavefront
    tri_block: int = 512        # dense: triangles per scan block (and the
                                # padding of the triangle tables)
    pallas_subgroup: int = 64   # pallas: rays per culling subgroup
    pairs_subgroup: int = 64    # rays per culling subgroup
    pairs_block: int = 4096     # ray padding granularity of a cast
    pairs_tile: int = 128       # triangles per packed tile
    pairs_cut: int = 0          # cluster-cut granularity; 0 = min(tile, 128)
    pairs_chunk: int = 524288   # rays per cast of the pairs and pallas
                                # traversals (bounds the culling and
                                # integrator intermediates)

    def __post_init__(self):
        if self.traversal == "bvh":
            raise NotImplementedError("traversal='bvh' is not ported yet")
        if self.traversal not in TRAVERSALS:
            raise ValueError(f"unknown traversal {self.traversal!r}; choose "
                             f"from {TRAVERSALS}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def build_scene_tables(
    spheres: list,
    materials: list,
    L,
    intensity: float,
    mesh: MeshData | None,
    device,
    mesh_albedo=(0.25, 0.25, 0.25),
    tri_block: int = 512,
    pairs_tile: int = 128,
    pairs_cut: int = 0,
) -> SceneTables:
    """Assemble the device tables from host data on ``device``.

    spheres: list of (center(3,), radius); materials: matching list of
    (albedo(3,), mirror, in_ri, out_ri).  The mesh (diffuse, albedo 0.25)
    is appended as the last object id.  A mesh past the pairs tables'
    ceiling (``PairsMeshTooLarge``) gets no pairs tables, with a warning,
    and ``traversal="pairs"`` then runs as ``pallas``, as in the JAX
    package (``render/pipeline.chunk_size`` sizes its casts to the pallas
    lists' 32-bit indices).
    """
    mats = list(materials)
    if mesh is not None:
        mats.append((mesh_albedo, False, 1.0, 1.0))
    t = lambda a: torch.tensor(a, device=device)
    alb = np.array([m[0] for m in mats], np.float32)
    tri = pallas = pairs = None
    if mesh is not None:
        pad_to = _round_up(mesh.n_tri, tri_block)
        tri = build_tri_tables(mesh.A, mesh.B, mesh.C, device, na=mesh.na,
                               nb=mesh.nb, nc=mesh.nc, pad_to=pad_to)
        pallas = build_pallas_tables(mesh.A, mesh.B, mesh.C, device,
                                     pad_to=pad_to)
        try:
            pairs = build_pairs_tables(
                mesh.A, mesh.B, mesh.C, mesh.bvh, device, tile_t=pairs_tile,
                vna=mesh.na, vnb=mesh.nb, vnc=mesh.nc,
                cut_tris=pairs_cut or None)
        except PairsMeshTooLarge as e:
            warnings.warn(f"pairs kernel unavailable for this mesh ({e}); "
                          "traversal='pairs' will fall back to 'pallas'",
                          stacklevel=2)
    Lf = np.asarray(L, np.float32)
    return SceneTables(
        spheres=SphereTable.from_list(spheres, device),
        materials=Materials(
            albedo=Vec3(t(alb[:, 0]), t(alb[:, 1]), t(alb[:, 2])),
            mirror=t(np.array([m[1] for m in mats], bool)),
            in_ri=t(np.array([m[2] for m in mats], np.float32)),
            out_ri=t(np.array([m[3] for m in mats], np.float32)),
        ),
        mesh=tri,
        pallas_mesh=pallas,
        pairs_mesh=pairs,
        L=Vec3.const(*(float(v) for v in Lf), device=device),
        intensity=torch.tensor(np.float32(intensity), device=device),
    )
