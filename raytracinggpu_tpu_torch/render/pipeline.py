"""Single-frame render pipeline (port of
``raytracinggpu_tpu/render/pipeline.py``):

    raygen (camera + Box-Muller jitter)  ->  wavefront trace  ->  average spp

Samples run in groups (``group_size``) whose rays form one wavefront: as
many as one pairs cast holds (pairs), ``SPP_FUSE`` (pallas, bvh, dense),
or at most ``cfg.spp_fuse`` where it is set.  Each wavefront is traced in
casts of ``chunk_size`` rays: as wide as the ladder's key, the kernels'
indices and the card's memory allow (pairs, ``pairs_cast_width``), at
most ``CAST_CAP`` (pallas, bvh), or ``cfg.ray_chunk`` (dense).  The
uniforms are keyed per (sample, row) with the threefry key that
``render_frame`` is given, and every sample's radiance is added to the
accumulator in sample order, so the frame is bitwise independent of the
group size.  ``sample_colors`` gives the samples unsummed and
``sum_samples`` adds them in that order: the sharded frame
(``parallel/sharding.py``) is built from them, and is bitwise this one.
A sample's primary rays and uniforms (``primary_rays``) come from the
kernel ``rt_primary_rays`` of ``csrc/wavefront.cu`` on the card, written
into its wavefront's buffers, and from ``primary_rays_plain`` on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from raytracinggpu_tpu_torch.core.device import on_cuda
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
from raytracinggpu_tpu_torch.ops.pairs_trace import key_lanes
from raytracinggpu_tpu_torch.ops.pallas_trace import BLK_R
from raytracinggpu_tpu_torch.scene.scene import RenderConfig, SceneTables
from raytracinggpu_tpu_torch.utils.profiling import count, request, span


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


def _focal_z(cfg: RenderConfig) -> float:
    """z = -W / (2 tan(fov/2)), rounded to f32."""
    return float(np.float32(-cfg.width / (2.0 * np.tan(cfg.fov / 2.0))))


def pixel_centers(cfg: RenderConfig, rows: np.ndarray, device):
    """Per-pixel screen offsets (ux, uy) for the given rows and the focal
    z: ux = x - W/2 + 0.5, uy = H/2 - y - 0.5, z = -W / (2 tan(fov/2))."""
    W, H = cfg.width, cfg.height
    x = np.arange(W, dtype=np.float32)
    y = np.asarray(rows).astype(np.float32)
    nr = y.shape[0]
    ux = np.broadcast_to((x - W / 2.0 + 0.5)[None, :], (nr, W)).reshape(-1)
    uy = np.broadcast_to((H / 2.0 - y - 0.5)[:, None], (nr, W)).reshape(-1)
    z = _focal_z(cfg)
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


def primary_rays_plain(cfg: RenderConfig, cam: Camera, key: Key, s: int,
                       rows_t, rows):
    """Sample ``s``'s primary rays over the global rows ``rows`` (numpy;
    ``rows_t`` the same as an int64 tensor on the device), in PyTorch ops
    (the contract of the kernel ``rt_primary_rays``): (O, u, the
    (max_depth, 2, nr*W) uniforms of the bounces), from the uniforms that
    ``row_uniforms`` keys by ``fold_in(key, s)`` and the rows."""
    un = row_uniforms(fold_in(key, s), rows_t, cfg.width, cfg.max_depth)
    jitter = box_muller_terms(un[0, 0], un[0, 1], cfg.sigma)
    O, u = raygen(cfg, cam, jitter, rows)
    return O, u, un[1:]


def primary_rays_into(cfg: RenderConfig, cam: Camera, key: Key, s: int,
                      rows_t, rows, O: Vec3, u: Vec3, un) -> None:
    """``primary_rays_plain`` copied into the buffers of ``primary_rays``."""
    O_p, u_p, un_p = primary_rays_plain(cfg, cam, key, s, rows_t, rows)
    for dst, src in zip((*O, *u, un), (*O_p, *u_p, un_p)):
        dst.copy_(src)


def primary_rays(cfg: RenderConfig, cam: Camera, key: Key, s: int, rows_t,
                 rows, O: Vec3, u: Vec3, un) -> None:
    """``primary_rays_plain`` written into O and u (contiguous (nr*W,)
    rows) and un ((max_depth, 2, nr*W), unit stride along the rays): the
    kernel ``rt_primary_rays`` for CUDA tensors, the plain version for CPU
    tensors."""
    with span("primary_rays"):
        if not on_cuda(rows_t):
            primary_rays_into(cfg, cam, key, s, rows_t, rows, O, u, un)
            return
        from raytracinggpu_tpu_torch.ops import _kernels

        f32 = lambda v: float(np.float32(v))
        _kernels.primary_rays(
            key, s, rows_t, (*cam.C, *cam.bx, *cam.by, *cam.bz), cfg.width,
            cfg.max_depth, cfg.camera_point_quirk, f32(cfg.sigma),
            f32(cfg.width / 2.0), f32(cfg.height / 2.0), _focal_z(cfg), O, u,
            un)


# Rays a cast of the pallas and bvh traversals at most, and of a pairs cast
# whose table's ladder key holds fewer lanes (the TPU's bound on the
# culling and integrator intermediates, kept where no key sets one).
CAST_CAP = 524288
# Device bytes that a lane of a pairs cast holds at its peak, a trace of
# depth d: CAST_LANE_BYTES[0] + d * CAST_LANE_BYTES[1] (the composite's
# per-depth stacks grow with d).  Measured on an H100 80GB HBM3 as the
# growth of ``torch.cuda.max_memory_allocated`` over one ``trace`` of the
# cat from 2^19 to 2^20 lanes, over the 2^19 lanes: 203.1, 245.2, 294.3
# and 370.2 bytes at depths 1, 3, 5 and 8 (array_bvh), 244.3 at depth 3
# (realtime); this line lies at or above each.
CAST_LANE_BYTES = (180, 24)
CAST_MEM_SHARE = 0.25   # of the device's memory, what a cast's lanes may take


def pairs_cast_width(cfg: RenderConfig, R: int,
                     scene: SceneTables | None) -> int:
    """The most rays a pairs cast of an R-ray wavefront takes: the largest
    multiple of cfg.pairs_block (one block at least) that is no larger
    than each of

    1. the most lanes that the ladder's int32 sort key holds in any mode
       (``ops/pairs_trace.key_lanes`` over the table's tile boxes, or
       their unions of cfg.pairs_key_coarse: mode 1, the first box
       alone): 2^25 for the cat's 40 tiles, 2^24 for the dog skeleton's
       89 union boxes.  A cast wider than the finest mode holds keys in
       mode 1 (``_key_mode``), which changes no ray's result.  CAST_CAP
       where that is fewer lanes, or the scene has no pairs table;
    2. the wavefront, R rounded up to whole blocks: a cast is never padded
       past it;
    3. the kernels' 32-bit indices (``ops/_kernels``): 16 ray rows a lane
       and the culling's (ceil(tiles / 32), rays / cfg.pairs_subgroup)
       words;
    4. on a card, CAST_MEM_SHARE of its memory over the bytes a lane of
       the cast holds (CAST_LANE_BYTES at cfg.max_depth);
    5. cfg.pairs_chunk, where it is set.

    Every ray's result, and the frame bit for bit, do not depend on the
    width (``chunk_size``); the ladder's tiers are fractions of it."""
    blk = cfg.pairs_block
    tab = None if scene is None else scene.pairs_mesh
    n_tiles = 0 if tab is None else tab.tile_aabb.shape[0]
    bounds = [-(-R // blk) * blk, (2**31 - 1) // 16,
              (2**31 - 1) // max(1, -(-n_tiles // 32)) * cfg.pairs_subgroup,
              max(CAST_CAP, key_lanes(n_tiles, cfg.pairs_key_coarse)
                  if tab is not None else 0)]
    if scene is not None and scene.device.type == "cuda":
        total = torch.cuda.get_device_properties(scene.device).total_memory
        base, per_depth = CAST_LANE_BYTES
        bounds.append(int(total * CAST_MEM_SHARE)
                      // (base + per_depth * cfg.max_depth))
    if cfg.pairs_chunk:
        bounds.append(cfg.pairs_chunk)
    return max(blk, min(bounds) // blk * blk)


def chunk_size(cfg: RenderConfig, R: int, traversal: str = "pairs",
               n_tiles: int = 0, scene: SceneTables | None = None) -> int:
    """Rays per cast for an R-ray wavefront.  pairs, pallas and bvh:
    near-equal casts of at most a width, each a whole number of
    cfg.pairs_block (pairs, bvh) or BLK_R (pallas) rays, so that the
    culling subgroups, and with them every ray's result, do not depend on
    the cast size.  pairs: the width of ``pairs_cast_width`` for
    ``scene``'s table.  pallas and bvh: cfg.pairs_chunk where set, else
    CAST_CAP.  (The JAX package caps a pallas cast at 2^17 rays for the
    TPU's scalar memory.)  A pallas cast over a table of ``n_tiles``
    tiles is also cut to whole BLK_R blocks whose tile lists,
    (rays / cfg.pallas_subgroup, 1 + n_tiles) int32, stay under the 2^31
    elements that the tiled kernels' 32-bit indices reach
    (``ops/_kernels._check``): a mesh past the pairs tables' ceiling has
    some 400,000 tiles, and its 524,288-ray cast's lists would pass it.
    bvh: the JAX package casts cfg.ray_chunk rays, a bound it sets for
    the dense oracle's products; every ray of the walk is its own, so the
    cast size changes no result, and the torch walk's fixed cost a step
    is paid per cast.  dense: casts of cfg.ray_chunk rays."""
    if traversal == "dense":
        return min(cfg.ray_chunk, R)
    blk = cfg.pairs_block
    if traversal == "pairs":
        cap = pairs_cast_width(cfg, R, scene)
    else:
        cap = cfg.pairs_chunk or CAST_CAP
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
                       n_tiles=0 if tiled is None else tiled.n_tiles,
                       scene=scene)
    pad = (-R) % chunk
    if pad:
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
    if len(cols) == 1:  # one cast holds the wavefront: nothing to join
        return Vec3(*(c[:R] for c in cols[0])), stats
    col = Vec3(*(torch.cat(c)[:R] for c in zip(*cols)))
    return col, stats


# Samples a wavefront of the pallas, bvh and dense traversals at most
# where cfg.spp_fuse is not set.
SPP_FUSE = 4


def group_size(cfg: RenderConfig, n_s: int, lanes: int,
               scene: SceneTables) -> int:
    """Samples per wavefront of n_s samples of ``lanes`` rays each: the
    largest divisor of n_s not above a cap.  The cap is cfg.spp_fuse
    where it is set; else, for the pairs traversal, the samples whose rays
    one cast of ``pairs_cast_width`` holds (at least one), so that a
    frame's samples trace in as few and as wide casts as the key, the
    card's memory and cfg.pairs_chunk allow; else SPP_FUSE."""
    if cfg.spp_fuse:
        cap = cfg.spp_fuse
    elif _effective_traversal(cfg, scene) == "pairs":
        cap = pairs_cast_width(cfg, n_s * lanes, scene) // lanes
    else:
        cap = SPP_FUSE
    g = max(1, min(cap, n_s))
    while n_s % g:
        g -= 1
    return g


def _add_stats(a: TraceStats | None, b: TraceStats) -> TraceStats:
    return b if a is None else TraceStats(*(x + y for x, y in zip(a, b)))


def _wavefronts(scene: SceneTables, cfg: RenderConfig, cam: Camera, key: Key,
                rows: np.ndarray, sample_ids):
    """Trace a set of global rows over a set of global sample ids in groups
    of ``group_size`` samples; a group's rays concatenate into one
    wavefront, sample-major.  Yields, group by group in sample order,
    (color Vec3 (g*nr*W,), g, TraceStats of the group).  While tracing is
    on, the counters ``wavefront.count`` and ``wavefront.samples`` add
    one and g a wavefront."""
    W, D = cfg.width, cfg.max_depth
    sample_ids = [int(s) for s in sample_ids]
    n_s = len(sample_ids)
    R = len(rows) * W
    g = group_size(cfg, n_s, R, scene)
    dev = scene.device
    rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    for g0 in range(0, n_s, g):
        count("wavefront.count")
        count("wavefront.samples", g)
        O, u = (torch.empty((3, g * R), dtype=torch.float32, device=dev)
                for _ in range(2))
        un = torch.empty((D, 2, g * R), dtype=torch.float32, device=dev)
        for k, s in enumerate(sample_ids[g0:g0 + g]):
            lanes = slice(k * R, (k + 1) * R)
            primary_rays(cfg, cam, key, s, rows_t, rows, Vec3(*O[:, lanes]),
                         Vec3(*u[:, lanes]), un[..., lanes])
        col, st = trace_chunked(scene, cfg, Vec3(*O), Vec3(*u), un)
        yield col, g, st


def render_rows(scene: SceneTables, cfg: RenderConfig, cam: Camera, key: Key,
                rows: np.ndarray, sample_ids) -> tuple[Vec3, TraceStats]:
    """Accumulated (unaveraged) radiance for a set of global rows over a set
    of global sample ids.  Returns (color Vec3 (nr*W,), TraceStats summed).

    Each wavefront's samples are added to the accumulator as it is traced,
    one sample at a time in sample order, from zero: the sum
    ``sum_samples`` forms from ``sample_colors``, bit for bit."""
    R = len(rows) * cfg.width
    with request("render"):
        acc = Vec3.zeros((R,), device=scene.device)
        stats = None
        for col, g, st in _wavefronts(scene, cfg, cam, key, rows,
                                      sample_ids):
            for i in range(g):
                acc = acc + Vec3(*(c[i * R:(i + 1) * R] for c in col))
            stats = _add_stats(stats, st)
    return acc, stats


def sample_colors(scene: SceneTables, cfg: RenderConfig, cam: Camera,
                  key: Key, rows: np.ndarray, sample_ids
                  ) -> tuple[torch.Tensor, TraceStats]:
    """The radiance of every sample of a set of global rows, unsummed:
    ((n_s, 3, nr*W) float32 in the order of ``sample_ids``, TraceStats
    summed).  The samples trace in the wavefronts ``render_rows`` traces,
    so each equals the term it adds."""
    R = len(rows) * cfg.width
    cols, stats = [], None
    with request("render"):
        for col, g, st in _wavefronts(scene, cfg, cam, key, rows,
                                      sample_ids):
            cols.append(torch.stack(tuple(col)).reshape(3, g, R)
                        .transpose(0, 1))
            stats = _add_stats(stats, st)
    return torch.cat(cols), stats


def sum_samples(cols: torch.Tensor) -> Vec3:
    """The accumulated radiance of (n_s, 3, R) per-sample colours: added
    one sample at a time, in their order, from zero, as ``render_rows``
    adds them."""
    acc = Vec3.zeros((cols.shape[-1],), device=cols.device)
    for c in cols:
        acc = acc + Vec3(*c)
    return acc


def frame_rows(cfg: RenderConfig, acc: Vec3) -> torch.Tensor:
    """(nr, W, 3) float32 rows of the frame from the accumulated radiance
    of cfg.spp samples."""
    col = acc / float(cfg.spp)
    return torch.stack([c.reshape(-1, cfg.width) for c in col], dim=-1)


def render_frame(scene: SceneTables, cfg: RenderConfig, cam: Camera, key: Key):
    """Render one frame: (H, W, 3) float32 radiance on the scene's device
    and the summed TraceStats.  Per sample, Box-Muller jitter then a full
    trace; colors averaged over cfg.spp samples."""
    rows = np.arange(cfg.height, dtype=np.int32)
    acc, stats = render_rows(scene, cfg, cam, key, rows, range(cfg.spp))
    return frame_rows(cfg, acc), stats


def render_preset_frame(scene: SceneTables, cfg: RenderConfig, seed: int = 0,
                        cam: Camera | None = None):
    """Host entry: (numpy image HxWx3 float32, TraceStats of numpy arrays)
    at ``PRNGKey(seed)``."""
    with request("frame"):
        dev = scene.device
        if cam is None:
            cam = Camera.default(cfg, dev)
        img, stats = render_frame(scene, cfg, cam, PRNGKey(seed, dev))
        with span("frame.readback"):
            return img.cpu().numpy(), TraceStats(*(s.cpu().numpy()
                                                   for s in stats))


def rays_per_frame(cfg: RenderConfig) -> int:
    """Reference ray-count formula: every depth adds one bounce ray and one
    shadow ray -> W*H*spp*(2*depth+1)."""
    return cfg.width * cfg.height * cfg.spp * (2 * cfg.max_depth + 1)
