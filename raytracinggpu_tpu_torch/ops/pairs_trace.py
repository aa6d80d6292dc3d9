"""Pairs mesh traversal: cluster-packed tiles, per-subgroup culling
bitmask, and the two mesh queries of the main path (port of
``raytracinggpu_tpu/ops/pairs_trace.py``).

The host build is the JAX package's numpy code: the reference midpoint
BVH is cut into clusters of <= 128 triangles, the clusters are packed
greedily in Morton order into 128-slot tiles, and every slot carries 32
field rows (0-15 the factorized Moller-Trumbore constants, 16 the original
triangle id as f32, 17-25 the vertex normals).  Culling tests each ray
against the per-cluster MEMBER boxes and ORs the hits per tile and per
subgroup of ``subg`` consecutive rays into a (W, R/subg) int32 bitmask.

The inner loop -- Moller-Trumbore over every (ray, slot) whose tile bit is
set for the ray's subgroup -- is the JAX package's Pallas ``_pairs_kernel``
in four specializations:

- B1, closest hit with the geometric-normal payload
  (``pairs_closest``): lexicographic min of (t, original id), winner's Ng;
- B3, closest hit with the smooth payload (``pairs_closest_smooth``): the
  same winner, N its Phong-interpolated vertex normal (field rows 17-25);
- B0, closest hit without a payload (``pairs_closest_idx``): t and id;
- B2, shadow (``pairs_shadow``): the nearest t only.

Each has a hand-written CUDA kernel (``csrc/pairs_trace.cu``, launched by
``ops/_kernels.py``) and, here, a plain PyTorch version of the same
function.  The public wrappers dispatch on the tensor's device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (or
raises).  Both compute every sum left to right in f32 with a reciprocal
and multiplies (never a divide); with the kernel built ``--fmad=false``
the two agree bit for bit on the card.  The slab test, the ray padding,
the plain Moller-Trumbore core and the device dispatch are the tiled
traversal's (``ops/pallas_trace.py``), as in the JAX package.

Big meshes (the JAX package's B4, ``_pairs_kernel`` over streamed
supertiles, ``n_st > 1``): the TPU kernel sweeps the field table in
``ST_SLOTS``-wide blocks because a program's field block must fit VMEM,
and carries its running min from one block to the next.  The port's
kernels read the fields from device memory with 32-bit indices, so B0-B3
walk every bitmask word and every slot of a table of any width in one
sweep, and one running min over all slots is the min carried across the
blocks.  The port therefore pads no table to whole supertiles and has no
tile-width rule for streaming; ``build_pairs_tables`` refuses only a
table past ``MAX_SLOTS``, where those indices end.

Left out of this port so far: the compaction ladder (exact by
construction, tuned for the TPU).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pallas_trace import (
    INF32,
    TILE_T,
    dispatch,
    mt_slots,
    pad_rays,
    plain_chunks,
    slab_enter_exit,
)
from raytracinggpu_tpu_torch.ops.triangle import TriHit

NUM_FIELDS = 32       # rows 0-15: MT constants; 16: original tri id;
                      # 17-25: vertex normals na/nb/nc; 26-31: pad
NUM_RF_ROWS = 16      # ray-feature rows: [u, w=O x u, O, 0-pad]
DEF_BLK = 4096        # ray padding granularity (RenderConfig.pairs_block)
DEF_SUBG = 16         # rays per culling subgroup
_IDX_BIG = np.int32(2**30)  # id of padding slots
# The kernels index the (NUM_FIELDS, Tc) field table with 32-bit ints
# (ops/_kernels._check: Tc * NUM_FIELDS < 2**31), so a table holds at most
# this many slots (67,108,863; 2**26 - 1).  The JAX package's MAX_SLOTS
# (2**21) is a TPU scalar-memory budget that the port does not have.
MAX_SLOTS = (2**31 - 1) // NUM_FIELDS


class PairsMeshTooLarge(ValueError):
    """The mesh's pairs table would pass MAX_SLOTS; the scene build then
    leaves the pairs tables out and ``traversal="pairs"`` runs as
    ``pallas``, as in the JAX package; ``render/pipeline.chunk_size``
    cuts those casts so that their active-tile lists stay within the
    tiled kernels' 32-bit indices."""


class PairsMeshTables(NamedTuple):
    """Cluster-tiled device tables.

    fields: (NUM_FIELDS, Tc) f32 per-slot constants in cluster-slot order
        (0-2 Ng, 3-5 e2 x A, 6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng,
        16 original BVH-order triangle id, 17-25 vertex normals).
    tile_aabb: (nc, 8) f32 [mn.xyz, mx.xyz, pad, pad] union box per tile.
    slot_src: (Tc,) int32 original tri id per slot (-1 on padding).
    member_aabb: (nm, 8) per-cluster boxes (the culling boxes);
    member_tile: (nm,) owning tile; member_slot: (Tc,) member id per slot
        (-1 on padding).
    """

    fields: torch.Tensor
    tile_aabb: torch.Tensor
    slot_src: torch.Tensor
    member_aabb: torch.Tensor
    member_tile: torch.Tensor
    member_slot: torch.Tensor


def tile_width(tab: PairsMeshTables) -> int:
    """Tile lane width of a built table (the slot array is exactly nc
    tiles of tile_t slots)."""
    return tab.slot_src.shape[0] // tab.tile_aabb.shape[0]


# ---------------------------------------------------------------- host build

def _cluster_slots(bvh, tile_t: int = TILE_T, cut_tris: int | None = None):
    """Host: cluster ranges -> (slot_src (nc*tile_t,), nc, members).

    The cluster cut (shallowest subtrees <= tile_t tris) is packed greedily
    in Morton order of the cluster box centers, first-fit within a window
    of recent tiles and under a box-growth bound, so spatial neighbours
    merge and the union boxes stay tight.  Packed tiles are not ascending
    in original id, which is why the closest hit breaks exact-t ties
    lexicographically on (t, original id)."""
    from raytracinggpu_tpu_torch.accel.bvh import cluster_cut
    from raytracinggpu_tpu_torch.accel.lbvh import morton_codes

    cut = cluster_cut(bvh, max_tris=min(cut_tris or tile_t, tile_t, 128))
    # A degenerate midpoint partition can leave a LEAF larger than
    # max_tris; split any oversized cluster into <= tile_t chunks (same
    # box; conservative) so no slot overflows its tile.
    c_starts, c_ends, c_mn, c_mx = [], [], [], []
    for ci in range(len(cut.starts)):
        s, e = int(cut.starts[ci]), int(cut.ends[ci])
        while s < e:
            c_starts.append(s)
            c_ends.append(min(s + tile_t, e))
            c_mn.append(cut.mn[ci])
            c_mx.append(cut.mx[ci])
            s += tile_t
    cut = cut._replace(
        starts=np.asarray(c_starts, np.int32),
        ends=np.asarray(c_ends, np.int32),
        mn=np.stack(c_mn).astype(np.float32),
        mx=np.stack(c_mx).astype(np.float32),
    )
    centers = (cut.mn + cut.mx) * 0.5
    order = np.argsort(morton_codes(centers), kind="stable")
    WINDOW = 8
    mesh_vol = float(np.prod(cut.mx.max(axis=0) - cut.mn.min(axis=0)))
    MAX_TILE_VOL = 0.02 * mesh_vol * (tile_t / 128.0)
    groups: list[list] = []  # [cluster ids, size, mn(3,), mx(3,)]
    for ci in order:
        size = int(cut.ends[ci] - cut.starts[ci])
        placed = False
        for g in groups[-WINDOW:]:
            if g[1] + size > tile_t:
                continue
            mn = np.minimum(g[2], cut.mn[ci])
            mx = np.maximum(g[3], cut.mx[ci])
            if float(np.prod(mx - mn)) > MAX_TILE_VOL:
                continue
            g[0].append(ci)
            g[1] += size
            g[2], g[3] = mn, mx
            placed = True
            break
        if not placed:
            groups.append([[ci], size, cut.mn[ci].copy(), cut.mx[ci].copy()])
    nc = len(groups)
    slot_src = np.full(nc * tile_t, -1, np.int32)
    member_slot = np.full(nc * tile_t, -1, np.int32)
    member_tile: list[int] = []
    member_aabb_rows: list[np.ndarray] = []
    for j, g in enumerate(groups):
        k = j * tile_t
        for ci in g[0]:
            s, e = int(cut.starts[ci]), int(cut.ends[ci])
            m = len(member_tile)
            member_tile.append(j)
            row = np.zeros(8, np.float32)
            row[0:3], row[3:6] = cut.mn[ci], cut.mx[ci]
            member_aabb_rows.append(row)
            slot_src[k : k + (e - s)] = np.arange(s, e, dtype=np.int32)
            member_slot[k : k + (e - s)] = m
            k += e - s
    members = (
        np.stack(member_aabb_rows, axis=0),
        np.asarray(member_tile, np.int32),
        member_slot,
    )
    return slot_src, nc, members


def fields_from_corners(A, B, C, slot_src, na=None, nb=None, nc=None):
    """(NUM_FIELDS, Tc) numpy field rows from BVH-ordered corners gathered
    per slot; na/nb/nc are optional (T, 3) vertex normals -> rows 17-25."""
    idx = np.maximum(slot_src, 0)

    def g(v):
        return np.where((slot_src >= 0)[:, None], v[idx], 0.0)

    Ag, Bg, Cg = g(A), g(B), g(C)
    e1 = Bg - Ag
    e2 = Cg - Ag
    ng = np.cross(e1, e2)
    Tc = slot_src.shape[0]
    rows = [
        ng.T, np.cross(e2, Ag).T, e2.T, np.cross(e1, Ag).T, e1.T,
        (Ag * ng).sum(axis=1)[None, :],
        np.where(slot_src >= 0, slot_src, _IDX_BIG).astype(A.dtype)[None, :],
    ]
    for v in (na, nb, nc):
        rows.append(np.zeros((3, Tc), A.dtype) if v is None else g(v).T)
    f = np.concatenate(rows, axis=0)
    pad = np.zeros((NUM_FIELDS - f.shape[0], Tc), A.dtype)
    return np.concatenate([f, pad], axis=0)


def build_pairs_tables(A, B, C, bvh, device, tile_t: int = TILE_T, vna=None,
                       vnb=None, vnc=None,
                       cut_tris: int | None = None) -> PairsMeshTables:
    """Host-side build from BVH-ordered triangle corners (T, 3); the tables
    land on ``device``.  cut_tris is the cluster-cut granularity (member-box
    tightness); results do not depend on it.  Raises PairsMeshTooLarge
    past MAX_SLOTS slots."""
    if tile_t <= 0 or tile_t % 32:
        raise ValueError(f"tile_t must be a positive multiple of 32, got {tile_t}")
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    slot_src, nc, (m_aabb, m_tile, m_slot) = _cluster_slots(
        bvh, tile_t, cut_tris=cut_tris)
    if nc * tile_t > MAX_SLOTS:
        raise PairsMeshTooLarge(
            f"mesh too large for the pairs kernels ({nc} tiles x {tile_t} "
            f"slots > {MAX_SLOTS}): their field indices are 32-bit; use "
            "traversal='pallas'")
    f = fields_from_corners(A, B, C, slot_src, na=vna, nb=vnb, nc=vnc)

    aabb = np.zeros((nc, 8), np.float32)
    for j in range(nc):
        ids = slot_src[j * tile_t : (j + 1) * tile_t]
        ids = ids[ids >= 0]
        pts = np.concatenate([A[ids], B[ids], C[ids]], axis=0)
        aabb[j, 0:3] = pts.min(axis=0)
        aabb[j, 3:6] = pts.max(axis=0)
    # member boxes refit tightly from the triangles
    for m in range(m_aabb.shape[0]):
        ids = slot_src[m_slot == m]
        pts = np.concatenate([A[ids], B[ids], C[ids]], axis=0)
        m_aabb[m, 0:3] = pts.min(axis=0)
        m_aabb[m, 3:6] = pts.max(axis=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PairsMeshTables(
        fields=t(f), tile_aabb=t(aabb), slot_src=t(slot_src),
        member_aabb=t(m_aabb), member_tile=t(m_tile), member_slot=t(m_slot),
    )


# ------------------------------------------------------------------ culling

def _pair_bits(O, u, nc, subg, members, cap=None, active=None):
    """Culling to a packed per-subgroup active-tile bitmask: (W, R/subg)
    int32, bit j of word (w, sg) set iff tile 32w+j is active for subgroup
    sg.  A member box is active for a ray when the ray's slab interval hits
    it (and enters it no later than ``cap``, for rays in ``active``); a tile
    is active for a subgroup when any ray of the subgroup activates any of
    its member boxes.  Bit 31 is the int32 sign bit (two's complement)."""
    boxes, member_tile = members
    R = O.x.shape[0]
    S = R // subg
    W = -(-nc // 32)
    nb = boxes.shape[0]
    # batch the slab tests over boxes: the (nb, R) intermediates would
    # otherwise grow with the mesh
    MB = 512
    mi = torch.zeros((nc, S), dtype=torch.int32, device=O.x.device)
    for b0 in range(0, nb, MB):
        bs = boxes[b0 : b0 + MB]
        nbb = bs.shape[0]
        enter, _exit, hit = slab_enter_exit(O, u, bs)
        if cap is not None:
            hit = hit & (enter <= cap[None, :])
        if active is not None:
            hit = hit & active[None, :]
        h = hit.reshape(nbb, S, subg).any(dim=2).to(torch.int32)
        mi.index_add_(0, member_tile[b0 : b0 + nbb].long(), h)
    act = F.pad((mi > 0).to(torch.int64), (0, 0, 0, W * 32 - nc))
    sh = torch.arange(32, dtype=torch.int64, device=O.x.device)
    words = (act.reshape(W, 32, S) << sh[None, :, None]).sum(dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _ray_feature_rows(O: Vec3, u: Vec3) -> torch.Tensor:
    """(16, R) ray-feature rows: [u(3), w=O x u(3), O(3), 0-pad]."""
    w = O.cross(u)
    rows = [u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z]
    z = torch.zeros_like(u.x)
    rows += [z] * (NUM_RF_ROWS - len(rows))
    return torch.stack(rows, dim=0).contiguous()


# --------------------------------------------- plain versions of B0-B3

def _plain_slot_t(rfT, fields, bits, eps_leaf, subg, tile_t, lo, hi):
    """Masked Moller-Trumbore for rays [lo, hi) against every slot:
    (t, beta, gamma), each (hi-lo, Tc) f32; t is INF where the slot's tile
    is culled for the ray's subgroup or the test fails.  The arithmetic
    order is the kernel's."""
    Tc = fields.shape[1]
    nc = Tc // tile_t
    tiles = torch.arange(nc, device=fields.device)
    sg = torch.arange(lo, hi, device=fields.device) // subg
    word = bits[tiles // 32][:, sg]                            # (nc, n)
    on = ((word >> (tiles % 32)[:, None]) & 1).bool().T        # (n, nc)
    on = on.repeat_interleave(tile_t, dim=1)                   # (n, Tc)
    tval, beta, gamma, ok = mt_slots(rfT, fields, eps_leaf, lo, hi)
    return torch.where(on & ok, tval, INF32), beta, gamma


def _plain_closest(rfT, fields, bits, eps_leaf, subg, tile_t, payload):
    """Plain closest hit: (t, idx) plus, for payload "geom" or "smooth",
    the winner's (nx, ny, nz).  t is the nearest valid hit (INF when
    none), idx the smallest original id among the slots at that t (0 on a
    miss), N that slot's unnormalized Ng (rows 0-2) or its vertex normals
    (rows 17-25) weighted by its own alpha, beta and gamma, summed left to
    right; zeros on a miss."""
    R = rfT.shape[1]
    outs = []
    for lo, hi in plain_chunks(R, fields.shape[1], subg):
        t, beta, gamma = _plain_slot_t(rfT, fields, bits, eps_leaf, subg,
                                       tile_t, lo, hi)
        tmin = t.amin(dim=1).clamp_max(INF32)
        hit = tmin < INF32
        win = (t == tmin[:, None]) & hit[:, None]
        ids = torch.where(win, fields[16][None, :], float(_IDX_BIG))
        slot = ids.argmin(dim=1)
        out = [tmin, torch.where(hit, fields[16][slot].to(torch.int32), 0)]
        if payload == "geom":
            n = [fields[k][slot] for k in range(3)]
        elif payload == "smooth":
            b = beta.gather(1, slot[:, None])[:, 0]
            g = gamma.gather(1, slot[:, None])[:, 0]
            a = 1.0 - b - g
            n = [fields[17 + k][slot] * a + fields[20 + k][slot] * b
                 + fields[23 + k][slot] * g for k in range(3)]
        else:
            n = []
        out += [torch.where(hit, c, 0.0) for c in n]
        outs.append(out)
    return tuple(torch.cat(parts) for parts in zip(*outs))


def pairs_closest_plain(rfT, fields, bits, eps_leaf, subg, tile_t):
    """Plain PyTorch B1: (t, idx, nx, ny, nz) per ray, N the winner's Ng."""
    return _plain_closest(rfT, fields, bits, eps_leaf, subg, tile_t, "geom")


def pairs_closest_smooth_plain(rfT, fields, bits, eps_leaf, subg, tile_t):
    """Plain PyTorch B3: (t, idx, nx, ny, nz) per ray, N the winner's
    na*alpha + nb*beta + nc*gamma."""
    return _plain_closest(rfT, fields, bits, eps_leaf, subg, tile_t, "smooth")


def pairs_closest_idx_plain(rfT, fields, bits, eps_leaf, subg, tile_t):
    """Plain PyTorch B0: (t, idx) per ray."""
    return _plain_closest(rfT, fields, bits, eps_leaf, subg, tile_t, None)


def pairs_shadow_plain(rfT, fields, bits, eps_leaf, subg, tile_t):
    """Plain PyTorch B2: the nearest valid hit t per ray (INF when none)."""
    R = rfT.shape[1]
    return torch.cat([
        _plain_slot_t(rfT, fields, bits, eps_leaf, subg, tile_t, lo, hi)[0]
        .amin(dim=1).clamp_max(INF32)
        for lo, hi in plain_chunks(R, fields.shape[1], subg)])


# ------------------------------------------------ device dispatch of B0-B3

def pairs_closest(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B1 on the tensors' device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    return dispatch("pairs_closest", pairs_closest_plain, rfT, fields, bits,
                    eps_leaf, subg, tile_t)


def pairs_closest_smooth(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B3 on the tensors' device (see pairs_closest)."""
    return dispatch("pairs_closest_smooth", pairs_closest_smooth_plain, rfT,
                    fields, bits, eps_leaf, subg, tile_t)


def pairs_closest_idx(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B0 on the tensors' device (see pairs_closest)."""
    return dispatch("pairs_closest_idx", pairs_closest_idx_plain, rfT,
                    fields, bits, eps_leaf, subg, tile_t)


def pairs_shadow(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B2 on the tensors' device (see pairs_closest)."""
    return dispatch("pairs_shadow", pairs_shadow_plain, rfT, fields, bits,
                    eps_leaf, subg, tile_t)


# ------------------------------------------------------------ public queries

def cast_inputs(O: Vec3, u: Vec3, tab: PairsMeshTables, subg: int,
                blk: int, cap=None, active=None):
    """The kernel inputs of one cast: (rfT (16, Rp), bits (W, Rp/subg), R)
    for the rays padded to Rp, a multiple of blk; outputs past R are
    padding."""
    O, u, cap, active, R = pad_rays(O, u, cap, blk, active)
    bits = _pair_bits(O, u, tab.tile_aabb.shape[0], subg,
                      (tab.member_aabb, tab.member_tile), cap=cap,
                      active=active)
    return _ray_feature_rows(O, u), bits, R


def intersect_tris_pairs(O: Vec3, u: Vec3, tab: PairsMeshTables,
                         eps_leaf: float, cap=None, subg: int = DEF_SUBG,
                         blk: int = DEF_BLK, payload: str | None = None):
    """Closest hit over the cluster-tiled mesh: TriHit with the ORIGINAL
    (BVH-order) triangle index.  ``cap`` (R,) culls tiles the ray enters
    beyond it (the caller's nearest sphere hit).

    payload: None | "geom" | "smooth".  When set, the kernel also tracks
    the winner's normal (geometric Ng, or the Phong-interpolated vertex
    normal from field rows 17-25) and the return becomes (TriHit, N), N
    unnormalized."""
    kernel = {None: pairs_closest_idx, "geom": pairs_closest,
              "smooth": pairs_closest_smooth}[payload]
    rfT, bits, R = cast_inputs(O, u, tab, subg, blk, cap=cap)
    out = [o[:R] for o in kernel(rfT, tab.fields, bits, eps_leaf, subg,
                                 tile_width(tab))]
    hit = TriHit(t=out[0], idx=out[1])
    return (hit, Vec3(*out[2:])) if payload else hit


def intersect_tris_pairs_shadow(O: Vec3, u: Vec3, tab: PairsMeshTables,
                                eps_leaf: float, cap=None,
                                subg: int = DEF_SUBG, blk: int = DEF_BLK,
                                active=None):
    """Nearest mesh hit distance only (occlusion query; ``cap`` = |L-P|
    culls tiles beyond the light).  ``active`` (R,) bool: lanes whose
    occlusion result is unused contribute no culling bits; a lane whose
    whole subgroup is inactive returns INF."""
    rfT, bits, R = cast_inputs(O, u, tab, subg, blk, cap=cap, active=active)
    return pairs_shadow(rfT, tab.fields, bits, eps_leaf, subg,
                        tile_width(tab))[:R]
