"""Single-frame render pipeline (port of
``raytracinggpu_tpu/render/pipeline.py``):

    raygen (camera + Box-Muller jitter)  ->  wavefront trace  ->  average spp

Samples run in groups of ``cfg.spp_fuse`` whose rays form one wavefront;
each wavefront is traced in casts of at most ``cfg.pairs_chunk`` rays
(pairs, pallas) or ``cfg.ray_chunk`` rays (dense; ``chunk_size``).  The
uniforms are keyed per (sample, row) with the threefry key that
``render_frame`` is given, and every sample's radiance is added to the
accumulator in sample order, so the frame is bitwise independent of the
group size.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from raytracinggpu_tpu_torch.core.rng import (
    Key,
    PRNGKey,
    box_muller_terms,
    fold_in,
    row_uniforms,
)
from raytracinggpu_tpu_torch.core.vec import Vec3, cos, fma, sin
from raytracinggpu_tpu_torch.integrator.wavefront import (
    TraceStats,
    _effective_traversal,
    trace,
)
from raytracinggpu_tpu_torch.ops.pallas_trace import BLK_R
from raytracinggpu_tpu_torch.scene.scene import RenderConfig, SceneTables


class Camera(NamedTuple):
    """Camera position and basis (0-d component tensors).  The fixed-view
    configs use the identity basis and C=(0,0,55) with fov pi/3; the
    realtime camera carries a yaw/pitch basis."""

    C: Vec3   # position
    bx: Vec3  # right
    by: Vec3  # up
    bz: Vec3  # basis z: the reference's rotate() re-derives bz = bx x by,
    #           (0,0,+1) at yaw = pitch = 0, and the forward component of a
    #           ray comes from bz * z with z = -W/(2 tan(fov/2)) negative

    @staticmethod
    def fixed(device, c=(0.0, 0.0, 55.0)) -> "Camera":
        """Identity basis at ``c`` (== from_yaw_pitch(c, 0, 0))."""
        return Camera(
            C=Vec3.const(*c, device=device),
            bx=Vec3.const(1.0, 0.0, 0.0, device=device),
            by=Vec3.const(0.0, 1.0, 0.0, device=device),
            bz=Vec3.const(0.0, 0.0, 1.0, device=device),
        )

    @staticmethod
    def default(cfg: RenderConfig, device) -> "Camera":
        """The config's default view: quirk (realtime) configs start at the
        reference camera's yaw 0, pitch 0.3; the fixed configs use the
        identity basis at cfg.camera_c."""
        if cfg.camera_point_quirk:
            return Camera.from_yaw_pitch(cfg.camera_c, 0.0, 0.3, device)
        return Camera.fixed(device, cfg.camera_c)

    @staticmethod
    def from_yaw_pitch(c, yaw, pitch, device) -> "Camera":
        """The reference's basis (realtime_render.cu rotate()): yaw about +Y,
        then pitch about the new right axis, re-orthogonalized with cross
        products and normalized.  ``c`` is a position tuple or a Vec3 of
        0-d tensors; yaw and pitch are rounded to f32 first."""
        f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        yaw, pitch = f32(yaw), f32(pitch)
        bx = Vec3.const(1.0, 0.0, 0.0, device=device)
        by = Vec3.const(0.0, 1.0, 0.0, device=device)
        bz = Vec3.const(0.0, 0.0, -1.0, device=device)
        bx = bx * cos(yaw) + bz * sin(yaw)
        bz = by.cross(bx)
        by = by * cos(pitch) - bz * sin(pitch)
        bz = bx.cross(by)
        C = c if isinstance(c, Vec3) else Vec3.const(*c, device=device)
        return Camera(C=C, bx=bx.normalized(), by=by.normalized(),
                      bz=bz.normalized())


def pixel_centers(cfg: RenderConfig, rows: np.ndarray, device):
    """Per-pixel screen offsets (ux, uy) for the given rows and the focal
    z: ux = x - W/2 + 0.5, uy = H/2 - y - 0.5, z = -W / (2 tan(fov/2))."""
    W, H = cfg.width, cfg.height
    x = np.arange(W, dtype=np.float32)
    y = np.asarray(rows).astype(np.float32)
    nr = y.shape[0]
    ux = np.broadcast_to((x - W / 2.0 + 0.5)[None, :], (nr, W)).reshape(-1)
    uy = np.broadcast_to((H / 2.0 - y - 0.5)[:, None], (nr, W)).reshape(-1)
    z = float(np.float32(-W / (2.0 * np.tan(cfg.fov / 2.0))))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(ux), t(uy), z


def raygen(cfg: RenderConfig, cam: Camera, jitter, rows) -> tuple[Vec3, Vec3]:
    """Primary rays for one sample, O = C.  ``jitter`` is
    ``core.rng.box_muller_terms``' (mag, c, s): the pixel jitter is
    (gx, gy) = (mag c, mag s), each product fused into the sum it enters,
    as XLA fuses it.

    Fixed configs: u = normalize(bx (ux+gx) + by (uy+gy) + bz z).
    Camera point quirk (realtime): the reference builds the point
    C + bz z + bx ux + by uy and normalizes it plus the world-frame jitter
    (gx, gy, 0) as the direction.  The sums round as XLA:CPU rounds them:
    it fuses bx ux into the sum before it, not by uy."""
    mag, c, s = jitter
    ux, uy, z = pixel_centers(cfg, rows, mag.device)
    R = ux.shape[0]
    O = Vec3(*(a.expand(R) for a in cam.C))
    if cfg.camera_point_quirk:
        d = Vec3(*(fma(bx, ux, o + bz * z) + by * uy for o, bx, by, bz in
                   zip(O, cam.bx, cam.by, cam.bz)))
        d = Vec3(fma(mag, c, d.x), fma(mag, s, d.y), d.z)
    else:
        d = (cam.bx * fma(mag, c, ux) + cam.by * fma(mag, s, uy)
             + cam.bz * z)
    return O, d.normalized()


def chunk_size(cfg: RenderConfig, R: int, traversal: str = "pairs",
               n_tiles: int = 0) -> int:
    """Rays per cast for an R-ray wavefront.  pairs and pallas: near-equal
    casts of at most cfg.pairs_chunk rays, each a whole number of
    cfg.pairs_block (pairs) or BLK_R (pallas) rays, so that the culling
    subgroups, and with them every ray's result, do not depend on the
    cast size.  (The JAX package caps a pallas cast at 2^17 rays for the
    TPU's scalar memory; the port takes the pairs cap, so both traversals
    launch as many casts.)  A pallas cast over a table of ``n_tiles``
    tiles is also cut to whole BLK_R blocks whose tile lists,
    (rays / cfg.pallas_subgroup, 1 + n_tiles) int32, stay under the 2^31
    elements that the tiled kernels' 32-bit indices reach
    (``ops/_kernels._check``): a mesh past the pairs tables' ceiling has
    some 400,000 tiles, and its 524,288-ray cast's lists would pass it.
    dense: casts of cfg.ray_chunk rays."""
    if traversal == "dense":
        return min(cfg.ray_chunk, R)
    cap, blk = cfg.pairs_chunk, cfg.pairs_block
    if traversal == "pallas":
        blk = BLK_R
        rows = (2**31 - 1) // (1 + n_tiles)   # list rows a cast may hold
        cap = min(cap, max(blk, rows * cfg.pallas_subgroup // blk * blk))
    n_chunks = -(-R // cap)
    per = -(-R // n_chunks)
    return min(cap, -(-per // blk) * blk)


def trace_chunked(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3,
                  uniforms):
    """Trace a wavefront in casts of ``chunk_size`` rays.  Padding rays
    have zero origin and direction (they miss everything) and are dropped.
    Returns (color Vec3 (R,), TraceStats summed over casts)."""
    R = u.x.shape[0]
    traversal = _effective_traversal(cfg, scene)
    tiled = scene.pallas_mesh if traversal == "pallas" else None
    chunk = chunk_size(cfg, R, traversal,
                       n_tiles=0 if tiled is None else tiled.n_tiles)
    pad = (-R) % chunk
    padv = lambda c: F.pad(c, (0, pad))
    O = Vec3(*map(padv, O))
    u = Vec3(*map(padv, u))
    uniforms = padv(uniforms)
    cols, stats = [], None
    for lo in range(0, R + pad, chunk):
        sl = lambda c: c[..., lo:lo + chunk]
        col, st = trace(scene, cfg, Vec3(*map(sl, O)), Vec3(*map(sl, u)),
                        sl(uniforms))
        cols.append(col)
        stats = st if stats is None else TraceStats(*(a + b for a, b in
                                                      zip(stats, st)))
    col = Vec3(*(torch.cat(c)[:R] for c in zip(*cols)))
    return col, stats


def group_size(cfg: RenderConfig, n_s: int) -> int:
    """Samples per wavefront: the largest divisor of n_s not above
    cfg.spp_fuse."""
    g = max(1, min(cfg.spp_fuse, n_s))
    while n_s % g:
        g -= 1
    return g


def render_rows(scene: SceneTables, cfg: RenderConfig, cam: Camera, key: Key,
                rows: np.ndarray, sample_ids) -> tuple[Vec3, TraceStats]:
    """Accumulated (unaveraged) radiance for a set of global rows over a set
    of global sample ids.  Returns (color Vec3 (nr*W,), TraceStats summed).

    Samples trace in groups of cfg.spp_fuse (the largest divisor of the
    sample count not above it); a group's rays concatenate into one
    wavefront, sample-major."""
    dev = scene.device
    W, D = cfg.width, cfg.max_depth
    R = len(rows) * W
    sample_ids = [int(s) for s in sample_ids]
    n_s = len(sample_ids)
    g = group_size(cfg, n_s)
    rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    acc = Vec3.zeros((R,), device=dev)
    stats = None
    for g0 in range(0, n_s, g):
        Os, us, uns = [], [], []
        for s in sample_ids[g0:g0 + g]:
            un = row_uniforms(fold_in(key, s), rows_t, W, D)  # (D+1, 2, R)
            jitter = box_muller_terms(un[0, 0], un[0, 1], cfg.sigma)
            O, u = raygen(cfg, cam, jitter, rows)
            Os.append(O)
            us.append(u)
            uns.append(un[1:])
        O = Vec3(*(torch.cat(c) for c in zip(*Os)))
        u = Vec3(*(torch.cat(c) for c in zip(*us)))
        col, st = trace_chunked(scene, cfg, O, u, torch.cat(uns, dim=-1))
        for i in range(g):
            acc = acc + Vec3(*(c[i * R:(i + 1) * R] for c in col))
        stats = st if stats is None else TraceStats(*(a + b for a, b in
                                                      zip(stats, st)))
    return acc, stats


def render_frame(scene: SceneTables, cfg: RenderConfig, cam: Camera, key: Key):
    """Render one frame: (H, W, 3) float32 radiance on the scene's device
    and the summed TraceStats.  Per sample, Box-Muller jitter then a full
    trace; colors averaged over cfg.spp samples."""
    W, H, spp = cfg.width, cfg.height, cfg.spp
    rows = np.arange(H, dtype=np.int32)
    acc, stats = render_rows(scene, cfg, cam, key, rows, range(spp))
    col = acc / float(spp)
    img = torch.stack([c.reshape(H, W) for c in col], dim=-1)
    return img, stats


def render_preset_frame(scene: SceneTables, cfg: RenderConfig, seed: int = 0,
                        cam: Camera | None = None):
    """Host entry: (numpy image HxWx3 float32, TraceStats of numpy arrays)
    at ``PRNGKey(seed)``."""
    dev = scene.device
    if cam is None:
        cam = Camera.default(cfg, dev)
    img, stats = render_frame(scene, cfg, cam, PRNGKey(seed, dev))
    return img.cpu().numpy(), TraceStats(*(s.cpu().numpy() for s in stats))


def rays_per_frame(cfg: RenderConfig) -> int:
    """Reference ray-count formula: every depth adds one bounce ray and one
    shadow ray -> W*H*spp*(2*depth+1)."""
    return cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth + 1)
