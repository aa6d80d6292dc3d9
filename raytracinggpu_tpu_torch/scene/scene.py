"""Scene device tables and static render configuration (port of
``raytracinggpu_tpu/scene/scene.py``).

Typed SoA tables -- one sphere table, the mesh's triangle, flat-BVH,
tiled and pairs tables and its base geometry for posing -- plus a
materials table indexed by object id: spheres 0..S-1, then the mesh at id
S, the reference's insertion order.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.accel.sah import build_sah_bvh
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
from raytracinggpu_tpu_torch.scene.transform import (
    MeshSource,
    build_mesh_source,
)
from raytracinggpu_tpu_torch.utils.profiling import build_count, build_span


class Materials(NamedTuple):
    """Per-object material columns, indexed by object id."""

    albedo: Vec3          # (M,)
    mirror: torch.Tensor  # (M,) bool
    in_ri: torch.Tensor   # (M,)
    out_ri: torch.Tensor  # (M,)


class BVHTables(NamedTuple):
    """Device copy of the flat BVH: one int32 column per field, the
    preorder skip links, and the node boxes."""

    left: torch.Tensor
    right: torch.Tensor       # -1 marks a leaf
    tri_start: torch.Tensor
    tri_end: torch.Tensor
    skip: torch.Tensor
    mn: Vec3
    mx: Vec3


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
    bvh: BVHTables | None = None       # the ``bvh`` traversal's tree
    mesh_src: MeshSource | None = None  # BVH-ordered base geometry that
                                        # scene/transform.pose_mesh poses

    @property
    def device(self) -> torch.device:
        return self.spheres.cx.device


TRAVERSALS = ("pairs", "pallas", "dense", "bvh")


@dataclass(frozen=True)
class RenderConfig:
    """Static parameters of one render: the fields of the JAX package's
    ``RenderConfig`` that the ported paths read, with its defaults."""

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
                                # | bvh (the reference's flat-BVH walk)
    ray_sort: bool = False      # pallas: sort rays into beam families
    ray_chunk: int = 65536      # dense: rays per cast
    spp_fuse: int | None = None  # samples a wavefront at most; None:
                                # render/pipeline's group_size (pairs:
                                # as many as one cast holds; the others
                                # pipeline.SPP_FUSE)
    tri_block: int = 512        # dense: triangles per scan block (and the
                                # padding of the triangle tables)
    pallas_subgroup: int = 64   # pallas: rays per culling subgroup
    pairs_subgroup: int = 64    # rays per culling subgroup
    pairs_block: int = 4096     # ray padding granularity of a cast
    pairs_tile: int = 128       # triangles per packed tile
    pairs_cluster: str = "ref"  # cluster tree of the pairs tables: 'ref'
                                # cuts the reference midpoint BVH, 'sah'
                                # an auxiliary binned-SAH tree
                                # (accel/sah.py); results are the same
    pairs_cut: int = 0          # cluster-cut granularity; 0 = min(tile, 128)
    pairs_pack: str = "morton"  # tile packing: 'morton' first-fit of whole
                                # clusters, 'pave' consecutive tree-order
                                # chunks at 100% occupancy
    pairs_compact: float = 0.078125  # the compaction ladder's tiers (see
    pairs_compact2: float = 0.1328125  # ops/pairs_trace._compact_tiers):
    pairs_compact3: float = 0.1875  # a pairs cast packs its rays with any
                                # active tile into the tightest tier of
                                # these fractions of its rays that holds
                                # them, and runs at full width when none
                                # does; 0 drops a tier.  Exact: the frame
                                # is the same with every tier at 0
    pairs_key_coarse: int = 1   # tiles a union box of the ladder's key
                                # (1: the exact per-tile key)
    pairs_compact_min_depth: int = 1  # first depth that runs the ladder;
                                # the depths below it run at full width
    pairs_chunk: int | None = None  # rays a cast of the pairs, pallas and
                                # bvh traversals at most; None: pairs
                                # casts sized by render/pipeline's
                                # pairs_cast_width, the others by
                                # pipeline.CAST_CAP
    bvh_node_layout: str = "soa"  # bvh: per-field columns, or the
                                # reference's 10-float record ('aos10')
    bvh_max_leaf: int = 96      # bvh: triangles tested a leaf at most
                                # (the cat's worst midpoint leaf holds 73;
                                # build_scene_tables warns past it)
    animate_mesh: bool = False  # realtime: spin the mesh every frame
                                # (scene/transform.pose_mesh)

    def __post_init__(self):
        if self.traversal not in TRAVERSALS:
            raise ValueError(f"unknown traversal {self.traversal!r}; choose "
                             f"from {TRAVERSALS}")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _to_device(x, device):
    """``x`` with every tensor in it (tuples and NamedTuples walked) on
    ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        items = [_to_device(v, device) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


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
    pairs_cluster: str = "ref",
    pairs_cut: int = 0,
    pairs_pack: str = "morton",
) -> SceneTables:
    """Assemble the device tables from host data on ``device``.

    spheres: list of (center(3,), radius); materials: matching list of
    (albedo(3,), mirror, in_ri, out_ri).  The mesh (diffuse, albedo 0.25)
    is appended as the last object id.  A mesh past the pairs tables'
    ceiling (``PairsMeshTooLarge``) gets no pairs tables, with a warning,
    and ``traversal="pairs"`` then runs as ``pallas``, as in the JAX
    package (``render/pipeline.chunk_size`` sizes its casts to the pallas
    lists' 32-bit indices).  pairs_cluster ``sah`` cuts the pairs
    clusters from an auxiliary SAH tree (``accel/sah.py``), whose
    ``order`` maps its leaves back to the canonical slot ids.

    The tables are built on the host, then copied to ``device`` in one
    step, the span ``build.upload``; the pairs tables' tiles and member
    boxes are the counters ``pairs.tiles`` and ``pairs.members``.
    """
    final_device, device = device, torch.device("cpu")
    mats = list(materials)
    if mesh is not None:
        mats.append((mesh_albedo, False, 1.0, 1.0))
    t = lambda a: torch.tensor(a, device=device)
    alb = np.array([m[0] for m in mats], np.float32)
    tri = pallas = pairs = bvh = src = None
    if mesh is not None:
        pad_to = _round_up(mesh.n_tri, tri_block)
        tri = build_tri_tables(mesh.A, mesh.B, mesh.C, device, na=mesh.na,
                               nb=mesh.nb, nc=mesh.nc, pad_to=pad_to)
        pallas = build_pallas_tables(mesh.A, mesh.B, mesh.C, device,
                                     pad_to=pad_to)
        if pairs_cluster not in ("ref", "sah"):
            raise ValueError(f"unknown pairs_cluster {pairs_cluster!r}; "
                             "choose from ('ref', 'sah')")
        cl_tree, ids_map = mesh.bvh, None
        if pairs_cluster == "sah":
            cl_tree = build_sah_bvh(mesh.A, mesh.B, mesh.C)
            ids_map = cl_tree.order
        try:
            pairs = build_pairs_tables(
                mesh.A, mesh.B, mesh.C, cl_tree, device, tile_t=pairs_tile,
                vna=mesh.na, vnb=mesh.nb, vnc=mesh.nc,
                cut_tris=pairs_cut or None, ids_map=ids_map, pack=pairs_pack)
        except PairsMeshTooLarge as e:
            warnings.warn(f"pairs kernel unavailable for this mesh ({e}); "
                          "traversal='pairs' will fall back to 'pallas'",
                          stacklevel=2)
        else:
            build_count("pairs.tiles", pairs.tile_aabb.shape[0])
            build_count("pairs.members", pairs.member_aabb.shape[0])
        src = build_mesh_source(mesh, pad_to, device)
        b = mesh.bvh
        max_leaf = int((b.tri_end - b.tri_start)[b.right == -1].max())
        default_max_leaf = RenderConfig.__dataclass_fields__[
            "bvh_max_leaf"].default
        if max_leaf > default_max_leaf:
            warnings.warn(
                f"BVH has a {max_leaf}-triangle leaf (> the default "
                f"bvh_max_leaf={default_max_leaf}): traversal='bvh' would "
                "skip triangles; raise RenderConfig.bvh_max_leaf or use "
                "builder='lbvh'", stacklevel=2)
        col = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
        bvh = BVHTables(
            left=col(b.left), right=col(b.right), tri_start=col(b.tri_start),
            tri_end=col(b.tri_end), skip=col(b.skip),
            mn=Vec3(*(col(b.mn[:, i]) for i in range(3))),
            mx=Vec3(*(col(b.mx[:, i]) for i in range(3))))
    Lf = np.asarray(L, np.float32)
    tables = SceneTables(
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
        bvh=bvh,
        mesh_src=src,
    )
    with build_span("build.upload"):
        return _to_device(tables, final_device)
