"""The differential cases that hold the port's integrator against the numpy
oracle, those of ``tests/test_fuzz_oracle.py`` and
``tests/test_realtime_differential.py``: random sphere scenes with every
material class, random triangle soups, and the realtime config with its
quirk camera and smooth normals.  ``tests/test_torch_oracle.py`` runs them
on the CPU at the JAX tests' sizes, ``chip_smoke.py`` phase 15 on the card
at larger ones.

Each case builds the port's ``SceneTables`` and the ``OracleScene`` from the
same spheres, materials, light and triangles (``scene_and_oracle``), and
draws its rays and its injected uniforms from a seeded numpy generator in
the order the JAX tests draw them.
"""
from __future__ import annotations

from dataclasses import replace
from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.accel.bvh import build_bvh
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.integrator.wavefront import trace
from raytracinggpu_tpu_torch.oracle.numpy_ref import OracleScene
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.mesh import MeshData, build_mesh, rescale
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
from raytracinggpu_tpu_torch.scene.presets import (
    build_preset,
    make_config,
    wall_spheres,
)
from raytracinggpu_tpu_torch.scene.scene import (
    RenderConfig,
    SceneTables,
    build_scene_tables,
)

INTENSITY = 3e10
MESH_MAT = ((0.25, 0.25, 0.25), False, 1.0, 1.0)  # every preset's mesh

# The JAX tests' bound: a ray disagrees when a channel is off by more than
# REL * |ref| + ABS, and fewer than this share of rays may disagree
REL, ABS = 3e-3, 3.0
SHARE = {"spheres": 0.04, "mesh": 0.05, "realtime": 0.04}
# Smooth normals through a mesh kernel against the dense traversal: a pixel
# disagrees past SMOOTH_REL * |dense| + SMOOTH_ABS, fewer than SMOOTH_SHARE
# may (a grazing edge can flip the winner, so the bound is a count)
SMOOTH_REL, SMOOTH_ABS, SMOOTH_SHARE = 1e-4, 2e-2, 0.01


class Case(NamedTuple):
    cfg: RenderConfig
    tables: SceneTables
    oracle: OracleScene
    O: np.ndarray         # (R, 3) f32 ray origins
    u: np.ndarray         # (R, 3) f32 unit directions
    uniforms: np.ndarray  # (max_depth, 2, R) f32 in (0, 1)


def scene_and_oracle(spheres, mats, L, device, mesh: MeshData | None = None,
                     tris=None, tri_normals=None):
    """The port's tables and the oracle's scene of one set of spheres,
    materials (the mesh's, diffuse 0.25, appended last by both) and light.
    ``mesh`` is the port's BVH-ordered mesh, ``tris`` (A, B, C) and
    ``tri_normals`` (Na, Nb, Nc) the same triangles and per-corner normals
    in their original order."""
    tables = build_scene_tables(spheres, mats, L=L, intensity=INTENSITY,
                                mesh=mesh, device=device)
    oracle = OracleScene(spheres, mats, L=L, intensity=INTENSITY, tris=tris,
                         mesh_mat=MESH_MAT if tris is not None else None,
                         tri_normals=tri_normals)
    return tables, oracle


def camera_rays(W: int, H: int, fov=np.pi / 3, C=(0, 0, 55)):
    """The fixed configs' primary rays without jitter, (R, 3) f32 each."""
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32)
    ux = np.tile(x - W / 2 + 0.5, H)
    uy = np.repeat(H / 2 - y - 0.5, W)
    z = np.float32(-W / (2 * np.tan(fov / 2)))
    d = np.stack([ux, uy, np.full(W * H, z, np.float32)], -1)
    u = d / np.linalg.norm(d, axis=-1, keepdims=True)
    O = np.tile(np.asarray(C, np.float32), (W * H, 1))
    return O.astype(np.float32), u.astype(np.float32)


def realtime_rays(W: int, H: int, cam_c=(0.0, 0.0, 55.0), yaw=0.0,
                  pitch=0.3, fov=np.pi / 2):
    """The reference realtime raygen (realtime_render.cu:1112-1123) in
    numpy: the yaw/pitch basis, the point quirk (u_center includes cam.C),
    no jitter."""
    bx = np.array([1.0, 0.0, 0.0])
    by = np.array([0.0, 1.0, 0.0])
    bz = np.array([0.0, 0.0, -1.0])
    cy, sy = np.cos(yaw), np.sin(yaw)
    bx = bx * cy + bz * sy
    bz = np.cross(by, bx)
    cp, sp = np.cos(pitch), np.sin(pitch)
    by = by * cp - bz * sp
    bz = np.cross(bx, by)
    bx /= np.linalg.norm(bx)
    by /= np.linalg.norm(by)
    bz /= np.linalg.norm(bz)
    z = -W / (2 * np.tan(fov / 2))
    x = np.arange(W, dtype=np.float32)
    y = np.arange(H, dtype=np.float32)
    ux = np.tile(x - W / 2 + 0.5, H)
    uy = np.repeat(H / 2 - y - 0.5, W)
    C = np.asarray(cam_c, np.float32)
    d = (C[None, :] + bz[None, :] * z + bx[None, :] * ux[:, None]
         + by[None, :] * uy[:, None])
    u = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    O = np.tile(C, (W * H, 1)).astype(np.float32)
    return O, u


def _uniforms(rng, depth: int, R: int) -> np.ndarray:
    return rng.random((depth, 2, R)).astype(np.float32) * 0.998 + 1e-3


def sphere_case(seed: int, device, size: int = 16, depth: int = 4) -> Case:
    """The walls and three random spheres, each diffuse, mirror or
    refractive at random, under the ``global`` config without a mesh."""
    rng = np.random.default_rng(seed)
    spheres, mats = wall_spheres(990.0)
    for _ in range(3):
        c = tuple(rng.uniform(-20, 20, 2)) + (float(rng.uniform(0, 30)),)
        r = float(rng.uniform(2, 8))
        kind = rng.integers(0, 3)
        if kind == 0:
            m = (tuple(rng.uniform(0, 1, 3)), False, 1.0, 1.0)
        elif kind == 1:
            m = ((0.0, 0.0, 0.0), True, 1.0, 1.0)
        else:
            m = ((0.0, 0.0, 0.0), False, float(rng.uniform(1.2, 1.8)), 1.0)
        spheres.append((c, r))
        mats.append(m)
    cfg = make_config("global", mesh_object_id=-1, n_objects=len(spheres),
                      width=size, height=size, spp=1, max_depth=depth)
    tables, oracle = scene_and_oracle(spheres, mats, (-10, 20, 40), device)
    O, u = camera_rays(size, size)
    return Case(cfg, tables, oracle, O, u, _uniforms(rng, depth, size * size))


def mesh_case(seed: int, traversal: str, device, size: int = 12,
              depth: int = 2, n_tri: int = 200) -> Case:
    """The walls and a soup of ``n_tri`` random triangles (no vertex
    normals) under the ``array_bvh`` config through ``traversal``."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-15, 15, (n_tri, 3)).astype(np.float32)
    B = A + rng.standard_normal((n_tri, 3)).astype(np.float32) * 3
    C = A + rng.standard_normal((n_tri, 3)).astype(np.float32) * 3
    bvh = build_bvh(A, B, C)
    o = bvh.order
    z = np.zeros_like(A)
    mesh = MeshData(A=A[o].copy(), B=B[o].copy(), C=C[o].copy(), na=z, nb=z,
                    nc=z, bvh=bvh, n_vertices=3 * n_tri, n_normals=0)
    spheres, mats = wall_spheres(990.0)
    tables, oracle = scene_and_oracle(spheres, mats, (-10, 20, 40), device,
                                      mesh=mesh, tris=(A, B, C))
    cfg = make_config("array_bvh", width=size, height=size, spp=1,
                      max_depth=depth, traversal=traversal)
    O, u = camera_rays(size, size)
    return Case(cfg, tables, oracle, O, u, _uniforms(rng, depth, size * size))


def realtime_case(traversal: str, device, size: int = 20, depth: int = 2,
                  seed: int = 1234) -> Case:
    """The ``realtime`` preset (the cat at 0.6 and (0, -10, 0), the 940
    floor, the light at (0, 15, 40), smooth normals) seen from the default
    quirk camera; the oracle takes the per-corner normals in the OBJ's
    triangle order."""
    obj = read_obj(CAT_OBJ_PATH)
    obj.vertices = rescale(obj.vertices, 0.6, (0, -10, 0))
    corners = lambda a, idx: tuple(a[idx[:, k]] for k in range(3))
    spheres, mats = wall_spheres(940.0)
    tables, oracle = scene_and_oracle(
        spheres, mats, (0, 15, 40), device, mesh=build_mesh(obj),
        tris=corners(obj.vertices, obj.vtx),
        tri_normals=corners(obj.normals, obj.nrm))
    cfg = make_config("realtime", width=size, height=size, spp=1,
                      max_depth=depth, traversal=traversal)
    O, u = realtime_rays(size, size)
    rng = np.random.default_rng(seed)
    return Case(cfg, tables, oracle, O, u, _uniforms(rng, depth, size * size))


def run(case: Case) -> tuple[np.ndarray, np.ndarray]:
    """(the port's colours, the oracle's), (R, 3) f32 each: the port's
    ``trace`` on the tables' device with the case's injected uniforms."""
    dev = case.tables.device
    vec = lambda a: Vec3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                           .to(dev) for i in range(3)))
    col, _ = trace(case.tables, case.cfg, vec(case.O), vec(case.u),
                   torch.from_numpy(case.uniforms).to(dev))
    got = torch.stack(tuple(col), -1).cpu().numpy()
    ref = case.oracle.trace(case.O, case.u, case.uniforms,
                            case.cfg.max_depth, case.cfg.eps_bounce,
                            case.cfg.eps_leaf)
    return got, ref


def disagree(got: np.ndarray, ref: np.ndarray) -> float:
    """Share of rays with a channel off by more than REL * |ref| + ABS."""
    return float((np.abs(got - ref) > REL * np.abs(ref) + ABS).any(-1).mean())


def smooth_frames(device, traversals=("dense", "pallas", "pairs"),
                  size: int = 32, seed: int = 3) -> dict:
    """Frames of the ``realtime`` preset with the cat as the OBJ gives it
    (unscaled), spp 1, depth 2, through each traversal: numpy (H, W, 3)."""
    cfg, tables = build_preset("realtime", device,
                               mesh=build_mesh(read_obj(CAT_OBJ_PATH)),
                               width=size, height=size, spp=1, max_depth=2)
    return {t: render_preset_frame(tables, replace(cfg, traversal=t),
                                   seed=seed)[0] for t in traversals}


def smooth_disagree(img: np.ndarray, dense: np.ndarray) -> float:
    """Share of pixels off the dense frame past the smooth-normal bound."""
    bad = np.abs(img - dense) > SMOOTH_REL * np.abs(dense) + SMOOTH_ABS
    return float(bad.any(-1).mean())
