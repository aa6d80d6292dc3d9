"""Scene presets (port of ``raytracinggpu_tpu/scene/presets.py``).

Each reference launcher hardcodes its own copy of the scene with small
deltas; here every variant is a named preset, six wall spheres plus:

- ``cpu`` (cpu_launcher.cpp): the cat as the OBJ reader embeds it,
  v * 0.8 + (0, -10, 0); sigma 0, eps_bounce 1e-3;
- ``global`` (global_launcher.cu): the embedded cat rescaled by 0.6 and
  moved by (0, -4, 0), v * 0.48 + (0, -10, 0) in all;
- ``optimized`` (optimized.cu): as ``global`` with leaf eps 0;
- ``array_bvh`` (different-versions/array_bvh.cu): the cat rescaled by
  0.6 and moved by (0, -10, 0), no embed;
- ``realtime`` (realtime_render.cu): the same cat, a floor of radius 940,
  the light at (0, 15, 40), fov pi/2, smooth normals, the camera point
  quirk, 20 spp and depth 3;
- ``showcase``: no mesh; the reference's commented-out object library, a
  white, a mirror and a nested refractive sphere (a glass shell around an
  air bubble), which runs every material branch of the integrator.

The mesh presets render with any ported traversal (``build_preset(...,
traversal="pallas")``); every mesh table is built either way, as in the
JAX package.  ``mesh=`` puts a custom mesh in the cat's place
(``api.Renderer(obj_path=...)``); ``showcase`` composes its own scene and
takes none.
"""
from __future__ import annotations

import warnings
from dataclasses import replace

import numpy as np

from raytracinggpu_tpu_torch.scene.mesh import MeshData, load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH
from raytracinggpu_tpu_torch.scene.scene import (
    RenderConfig,
    SceneTables,
    build_scene_tables,
)

PRESET_NAMES = ("cpu", "global", "optimized", "array_bvh", "realtime", "showcase")

_WALL_ALBEDOS = {
    "fore": (0.0, 1.0, 0.0),     # green fore wall
    "floor": (0.0, 0.0, 1.0),    # blue floor
    "ceiling": (1.0, 0.0, 0.0),  # red ceiling
    "left": (0.0, 1.0, 1.0),     # cyan left wall
    "right": (1.0, 1.0, 0.0),    # yellow right wall
    "back": (1.0, 0.0, 1.0),     # magenta back wall
}

# preset -> (embed 0.8/(0,-10,0) in read_obj, rescale scale, rescale
# offset) of the cat
_MESH_TRANSFORM = {
    "cpu": (True, None, None),
    "global": (True, 0.6, (0.0, -4.0, 0.0)),
    "optimized": (True, 0.6, (0.0, -4.0, 0.0)),
    "array_bvh": (False, 0.6, (0.0, -10.0, 0.0)),
    "realtime": (False, 0.6, (0.0, -10.0, 0.0)),
}


def wall_spheres(floor_radius: float):
    """The six enclosing wall spheres; the floor radius is 990 in the batch
    launchers and 940 in realtime."""
    diffuse = lambda alb: (alb, False, 1.0, 1.0)
    spheres = [
        ((0.0, 0.0, -1000.0), 940.0),
        ((0.0, -1000.0, 0.0), floor_radius),
        ((0.0, 1000.0, 0.0), 940.0),
        ((-1000.0, 0.0, 0.0), 940.0),
        ((1000.0, 0.0, 0.0), 940.0),
        ((0.0, 0.0, 1000.0), 940.0),
    ]
    mats = [diffuse(_WALL_ALBEDOS[k])
            for k in ("fore", "floor", "ceiling", "left", "right", "back")]
    return spheres, mats


def make_config(preset: str, **overrides) -> RenderConfig:
    base = dict(name=preset)
    if preset == "cpu":
        base.update(sigma=0.0, eps_bounce=1e-3, eps_leaf=1e-4)
    elif preset in ("global", "array_bvh"):
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=1e-4)
    elif preset == "optimized":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=0.0)
    elif preset == "realtime":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=1e-3,
                    fov=float(np.pi / 2), smooth_normals=True,
                    camera_point_quirk=True, spp=20, max_depth=3)
    elif preset == "showcase":
        base.update(sigma=0.2, eps_bounce=1e-4, eps_leaf=1e-4,
                    n_objects=10, mesh_object_id=-1)
    else:
        raise ValueError(f"unknown preset {preset!r}; choose from {PRESET_NAMES}")
    cfg = RenderConfig(**base)
    return replace(cfg, **overrides) if overrides else cfg


def build_preset(preset: str, device, mesh: MeshData | None = None,
                 **config_overrides) -> tuple[RenderConfig, SceneTables]:
    """Build (config, scene tables on ``device``) for a named preset.  The
    cat is loaded with the preset's transform, unless ``mesh`` gives an
    already-built MeshData (a custom mesh)."""
    cfg = make_config(preset, **config_overrides)
    if preset == "showcase":
        if mesh is not None:
            raise ValueError("the 'showcase' preset has no mesh slot")
        spheres, mats = wall_spheres(floor_radius=990.0)
        spheres += [
            ((0.0, 0.0, 18.0), 5.0),    # white sphere
            ((-13.0, 0.0, 18.0), 5.0),  # mirror sphere
            ((13.0, 0.0, 18.0), 5.0),   # outer refractive sphere (glass)
            ((13.0, 0.0, 18.0), 4.5),   # inner nested sphere (air bubble)
        ]
        mats += [
            ((1.0, 1.0, 1.0), False, 1.0, 1.0),
            ((0.0, 0.0, 0.0), True, 1.0, 1.0),
            ((0.0, 0.0, 0.0), False, 1.5, 1.0),  # in 1.5, out 1: glass shell
            ((0.0, 0.0, 0.0), False, 1.0, 1.5),  # in 1, out 1.5: bubble
        ]
        return cfg, build_scene_tables(spheres, mats, L=(-10.0, 20.0, 40.0),
                                       intensity=3e10, mesh=None,
                                       device=device)
    realtime = preset == "realtime"
    spheres, mats = wall_spheres(floor_radius=940.0 if realtime else 990.0)
    L = (0.0, 15.0, 40.0) if realtime else (-10.0, 20.0, 40.0)
    if mesh is None:
        mesh = load_cat_mesh(CAT_OBJ_PATH, *_MESH_TRANSFORM[preset])
    if cfg.smooth_normals and not np.any(mesh.na):
        # A mesh without vertex normals: Phong interpolation of the all-zero
        # fallback normals would give N = 0 and NaN bounce rays.
        warnings.warn("mesh has no vertex normals; smooth_normals disabled "
                      "(geometric normals used instead)", stacklevel=2)
        cfg = replace(cfg, smooth_normals=False)
    tables = build_scene_tables(
        spheres, mats, L=L, intensity=3e10, mesh=mesh, device=device,
        mesh_albedo=(0.25, 0.25, 0.25), tri_block=cfg.tri_block,
        pairs_tile=cfg.pairs_tile, pairs_cut=cfg.pairs_cut,
    )
    return _autotune_pairs(cfg, tables, config_overrides), tables


def _autotune_pairs(cfg, tables, overrides):
    """Tile-count-adaptive subgroup: 16 rays past 128 tiles, else the
    configured 64 (every preset's cat packs into 40 tiles), unless the
    caller set ``pairs_subgroup``.  The per-cast culling bits depend on
    the subgroup, so the port keeps the JAX package's rule.  Its threshold
    was tuned on the TPU; on the H100 the 2,053-tile soup's frame is 7%
    faster at 16 than at 64 (PERF.md, "What B4 taught"), and the
    ``pairslope`` probe (``bench/micro_kernel.py``) prices subgroups 8 to
    64.  (The JAX rule's second knob, ``pairs_key_coarse`` from 1024
    tiles, coarsens the compaction key, and the port has no compaction.)"""
    if tables.pairs_mesh is None:
        return cfg
    nc = int(tables.pairs_mesh.tile_aabb.shape[0])
    if "pairs_subgroup" not in overrides and nc > 128:
        return replace(cfg, pairs_subgroup=16)
    return cfg
