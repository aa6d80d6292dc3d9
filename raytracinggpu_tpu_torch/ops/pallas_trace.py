"""Tiled-kernel mesh traversal (``traversal="pallas"``): tile culling into
per-subgroup active-tile lists and the closest-hit and shadow queries
(port of ``raytracinggpu_tpu/ops/pallas_trace.py``).

The triangles stay in BVH (preorder leaf) order, cut into consecutive
128-triangle tiles whose boxes are the acceleration structure.  A cast:

- pads the rays to a whole number of ``BLK_R`` (padding lanes carry
  O = 0, u = 1, cap = 0) and, with ``sort_rays``, groups them into beam
  families (``ray_sort_key``);
- culls: a slab test of every ray against every tile box (and
  ``enter <= cap`` when a cap is given), ORed over each subgroup of
  ``subg`` consecutive rays into one row [count, active ids ascending,
  then the inactive ids] per subgroup (``_block_active_tiles``: the
  kernel ``rt_tile_lists`` of ``csrc/cull.cu`` on CUDA tensors,
  ``block_active_tiles_plain`` on CPU tensors);
- runs Moller-Trumbore for every ray over the 128 triangles of each tile
  in its subgroup's list: B5 (``pallas_closest``) keeps the nearest valid
  t with the lowest index on exact-t ties, B6 (``pallas_shadow``) the
  nearest t only.  A miss gives t = INF and idx 0.

B5 and B6 are hand-written CUDA kernels (``csrc/pallas_trace.cu``,
launched by ``ops/_kernels.py``); beside each sits its plain PyTorch
version.  The public wrappers dispatch on the tensor's device: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (or
raises).  Both round every product and sum alike (see
``ops/pairs_trace.py``), so they agree bit for bit on the card.

The lists are int32 rows.  The JAX package's int8/int16 lists, its
scalar-prefetch ray cap (``smem_ray_cap_pallas``, ``_chunked_rays``) and
its 32,766-tile limit exist for the TPU's scalar memory and are left out.

This module also holds what the pairs traversal shares with it (the slab
test, the ray padding, the plain Moller-Trumbore core and the device
dispatch), as in the JAX package, where pairs imports from pallas.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from raytracinggpu_tpu_torch.core.device import on_cuda as _on_cuda
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.triangle import TriHit

INF = 1e9 + 9
INF32 = float(np.float32(INF))  # the value every f32 comparison sees: 1e9
TILE_T = 128   # triangles per tile
BLK_R = 1024   # ray padding granularity of a cast
SUBG = 64      # rays per culling subgroup
NUM_FIELDS = 16
_IDX_BIG = 2**30  # id no triangle has
# Elements of one (ray chunk x slots) intermediate in the plain versions.
_PLAIN_ELEMS = 1 << 22
# Tile boxes per slab-test batch in the culling.
_BOX_BATCH = 512


class PallasMeshTables(NamedTuple):
    """Tiled device tables.

    fields: (16, Tp) f32 per-triangle constants in BVH order:
        0-2 Ng, 3-5 e2 x A, 6-8 e2, 9-11 e1 x A, 12-14 e1, 15 A.Ng
    fieldsT: (Tp, 16) transposed copy: winner recovery gathers one row.
    tile_aabb: (n_tiles, 8) f32 [mn.xyz, mx.xyz, pad, pad]; padding-only
        tiles carry the inverted box mn = +INF, mx = -INF.
    n_tiles: Tp // 128.
    """

    fields: torch.Tensor
    fieldsT: torch.Tensor
    tile_aabb: torch.Tensor
    n_tiles: int


def build_pallas_tables(A, B, C, device,
                        pad_to: int | None = None) -> PallasMeshTables:
    """Host-side build from BVH-ordered triangle corners (T, 3); the
    tables land on ``device``."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    Tp = pad_to or -(-T // TILE_T) * TILE_T
    Tp = -(-Tp // TILE_T) * TILE_T

    def pad(v):
        return np.pad(v, ((0, Tp - T), (0, 0)))

    Ap, Bp, Cp = pad(A), pad(B), pad(C)
    e1 = Bp - Ap
    e2 = Cp - Ap
    ng = np.cross(e1, e2)

    f = np.zeros((NUM_FIELDS, Tp), np.float32)
    f[0:3] = ng.T
    f[3:6] = np.cross(e2, Ap).T
    f[6:9] = e2.T
    f[9:12] = np.cross(e1, Ap).T
    f[12:15] = e1.T
    f[15] = np.einsum("td,td->t", Ap, ng)

    n_tiles = Tp // TILE_T
    aabb = np.zeros((n_tiles, 8), np.float32)
    for j in range(n_tiles):
        s, e = j * TILE_T, min((j + 1) * TILE_T, T)
        if s >= T:  # padding-only tile: an empty box
            aabb[j, 0:3] = INF
            aabb[j, 3:6] = -INF
            continue
        pts = np.concatenate([A[s:e], B[s:e], C[s:e]], axis=0)
        aabb[j, 0:3] = pts.min(axis=0)
        aabb[j, 3:6] = pts.max(axis=0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return PallasMeshTables(fields=t(f), fieldsT=t(f.T), tile_aabb=t(aabb),
                            n_tiles=n_tiles)


# --------------------------------------------------------------- ray prep

def pad_rays(O: Vec3, u: Vec3, cap, blk: int, active=None):
    """Pad the ray axis to a multiple of blk: padding lanes carry O=0,
    u=(1,1,1), cap=0 and active=False, as the JAX package pads them.
    Returns (O, u, cap, active, R) with R the unpadded ray count."""
    R = O.x.shape[0]
    pad = (-R) % blk
    if pad:
        O = Vec3(*(F.pad(c, (0, pad)) for c in O))
        u = Vec3(*(F.pad(c, (0, pad), value=1.0) for c in u))
        if cap is not None:
            cap = F.pad(cap, (0, pad))
        if active is not None:
            active = F.pad(active, (0, pad))
    return O, u, cap, active, R


def ray_sort_key(O: Vec3, u: Vec3) -> torch.Tensor:
    """Coherence key: direction octant (3 bits) x quantized origin cell
    (4x4x4 over the box [-64, 64]^3)."""
    octant = ((u.x < 0).to(torch.int32) * 4 + (u.y < 0).to(torch.int32) * 2
              + (u.z < 0).to(torch.int32))
    q = lambda c: ((c + 64.0) * (4.0 / 128.0)).to(torch.int32).clamp(0, 3)
    cell = (q(O.x) * 4 + q(O.y)) * 4 + q(O.z)
    return cell * 8 + octant


def _sort_rays(O: Vec3, u: Vec3, extra=()):
    """(perm, O sorted, u sorted, extras sorted), stable in the key."""
    perm = torch.argsort(ray_sort_key(O, u), stable=True)
    g = lambda c: c[perm]
    return perm, Vec3(*map(g, O)), Vec3(*map(g, u)), tuple(map(g, extra))


def _unsort(perm, *arrays):
    """Scatter sorted-order results back to the original ray order."""
    outs = []
    for a in arrays:
        out = torch.empty_like(a)
        out[perm] = a
        outs.append(out)
    return tuple(outs)


def ray_rows_plain(O: Vec3, u: Vec3, cap=None, active=None,
                   layout: str = "pairs") -> torch.Tensor:
    """Plain PyTorch: a cast's ray-feature rows, (nrows, R) f32, [u(3),
    w = O x u(3), O(3), ...] (the contract of the kernel ``rt_ray_rows``).

    layout ``pallas``: then 1/u(3) and 4 zero rows, the JAX package's
    (R, 16) ``_ray_features16`` transposed so that a kernel thread per ray
    reads each row coalesced.  ``pairs`` and ``live``: then the extras,
    ``cap`` (row 9) and, with ``active``, cap or a zero row and the mask
    as 1.0 / 0.0 (row 10), and in the ``pairs`` layout zero rows to 16
    (the JAX package's ``_ray_feature_rows``; ``live`` keeps the live rows
    only, its ``pad=False``)."""
    from raytracinggpu_tpu_torch.ops._kernels import ray_row_count

    n = ray_row_count(cap, active, layout)
    w = O.cross(u)
    rows = [u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z]
    if layout == "pallas":
        z = torch.zeros_like(u.x)
        rows += [1.0 / u.x, 1.0 / u.y, 1.0 / u.z, z, z, z, z]
    elif active is not None:
        rows += [torch.zeros_like(O.x) if cap is None else cap,
                 active.to(torch.float32)]
    elif cap is not None:
        rows.append(cap)
    rows += [torch.zeros_like(u.x)] * (n - len(rows))
    return torch.stack(rows, dim=0).contiguous()


def ray_rows(O: Vec3, u: Vec3, cap=None, active=None,
             layout: str = "pairs") -> torch.Tensor:
    """The rows of ``ray_rows_plain`` on the rays' device: the kernel
    ``rt_ray_rows`` of ``csrc/glue.cu`` for CUDA tensors, the plain
    version for CPU tensors."""
    if _on_cuda(O.x):
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.ray_rows(O, u, cap, active, layout)
    return ray_rows_plain(O, u, cap, active, layout)


def _ray_features16(O: Vec3, u: Vec3) -> torch.Tensor:
    """(16, R) ray-feature rows [u(3), w = O x u(3), O(3), 1/u(3), 0(4)]
    of a tiled cast (``ray_rows`` in the ``pallas`` layout)."""
    return ray_rows(O, u, layout="pallas")


# ------------------------------------------------------------------ culling

def _check_subg(subg: int) -> None:
    """A subgroup must tile the 128-ray rows and 1024-ray blocks the JAX
    kernel walks; the port keeps the JAX package's rule so that both
    accept the same configurations."""
    if subg <= 0 or subg > TILE_T or TILE_T % subg or BLK_R % subg:
        raise ValueError(
            f"pallas_subgroup={subg} unsupported: must divide TILE_T "
            f"({TILE_T}) and BLK_R ({BLK_R})")


def slab_enter_exit(O: Vec3, u: Vec3, aabb):
    """Per-ray slab intervals against every box, (n_boxes, R) layout.
    ``1/u`` gives +-inf and ``0*inf`` NaN; ``torch.minimum``/``maximum``
    propagate NaN as ``jnp.minimum``/``maximum`` do, so a NaN lane culls
    identically."""
    big = float(np.float32(3.4e38))
    shape = (aabb.shape[0], O.x.shape[0])
    enter = torch.full(shape, -big, device=O.x.device)
    exit_ = torch.full(shape, big, device=O.x.device)
    for ax, (Oc, uc) in enumerate(((O.x, u.x), (O.y, u.y), (O.z, u.z))):
        rc = 1.0 / uc
        t0 = (aabb[:, ax, None] - Oc[None, :]) * rc[None, :]
        t1 = (aabb[:, 3 + ax, None] - Oc[None, :]) * rc[None, :]
        enter = torch.maximum(enter, torch.minimum(t0, t1))
        exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
    # exit >= enter (NOT strict): a zero-thickness box of planar geometry
    # has enter == exit at the hit plane; culling stays conservative.
    hit = (exit_ >= enter) & (exit_ >= 0.0)
    return enter, exit_, hit


def block_active_tiles_plain(O: Vec3, u: Vec3, aabb, n_tiles: int, cap=None,
                             subg: int = SUBG):
    """Plain PyTorch per-subgroup tile culling to (R/subg, 1 + n_tiles)
    int32 rows [count, active tile ids ascending, inactive ids ascending].

    A tile is active for a ray when the ray's slab interval hits its box
    (and enters it no later than ``cap``); for a subgroup when it is
    active for any of its rays.  Padding-only tiles carry an inverted box,
    which the slab test's per-axis min/max would turn into a
    hit-everything interval, so invalid boxes are culled explicitly."""
    R = O.x.shape[0]
    S = R // subg
    act = []
    for b0 in range(0, n_tiles, _BOX_BATCH):
        bs = aabb[b0:min(b0 + _BOX_BATCH, n_tiles)]
        enter, _exit, hit = slab_enter_exit(O, u, bs)
        if cap is not None:
            hit = hit & (enter <= cap[None, :])
        hit = hit & (bs[:, 0] <= bs[:, 3])[:, None]
        act.append(hit.reshape(bs.shape[0], S, subg).any(dim=2))
    blk = torch.cat(act).T                                  # (S, n_tiles)
    order = torch.argsort((~blk).to(torch.uint8), dim=1, stable=True)
    count = blk.sum(dim=1, keepdim=True)
    return torch.cat([count, order], dim=1).to(torch.int32).contiguous()


def _block_active_tiles(O: Vec3, u: Vec3, aabb, n_tiles: int, cap=None,
                        subg: int = SUBG):
    """The list rows of ``block_active_tiles_plain`` on the rays' device:
    the kernel of ``csrc/cull.cu`` (``_kernels.tile_lists``) for CUDA
    tensors, the plain version for CPU tensors."""
    if _on_cuda(O.x):
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.tile_lists(O, u, aabb, n_tiles, cap, subg)
    return block_active_tiles_plain(O, u, aabb, n_tiles, cap, subg)


# ------------------------------------------- plain versions of B5 and B6

def mt_slots(rfT, fields, eps_leaf, lo, hi):
    """Plain Moller-Trumbore for rays [lo, hi) of the feature rows rfT
    ([u, w, O] in rows 0-8) against every column of the field rows
    (0-15 as in ``PallasMeshTables``): (t, beta, gamma, valid), each
    (hi-lo, Tc).  The arithmetic order is the kernels': every sum left to
    right, a reciprocal and multiplies; valid = denom != 0, min(beta,
    gamma, 1 - beta - gamma) >= 0 (false on NaN) and t > max(eps, 0)."""
    ux, uy, uz, wx, wy, wz, Ox, Oy, Oz = (rfT[k, lo:hi, None]
                                          for k in range(9))
    row = lambda k: fields[k][None, :]
    denom = ux * row(0) + uy * row(1) + uz * row(2)
    bnum = (ux * row(3) + uy * row(4) + uz * row(5)) - (
        wx * row(6) + wy * row(7) + wz * row(8))
    gnum = (wx * row(12) + wy * row(13) + wz * row(14)) - (
        ux * row(9) + uy * row(10) + uz * row(11))
    tnum = row(15) - (Ox * row(0) + Oy * row(1) + Oz * row(2))
    rden = 1.0 / denom
    beta = bnum * rden
    gamma = gnum * rden
    tval = tnum * rden
    bary_ok = torch.minimum(torch.minimum(beta, gamma),
                            1.0 - beta - gamma) >= 0.0
    eps = float(np.float32(max(float(eps_leaf), 0.0)))
    return tval, beta, gamma, (denom != 0.0) & bary_ok & (tval > eps)


def plain_chunks(R: int, Tc: int, subg: int):
    """Ray ranges of whole subgroups bounding a plain version's (rays x
    slots) intermediates by _PLAIN_ELEMS."""
    n = max(subg, _PLAIN_ELEMS // max(Tc, 1) // subg * subg)
    return ((lo, min(lo + n, R)) for lo in range(0, R, n))


def _listed_tiles(lists, n_tiles: int):
    """(S, n_tiles) bool: tile j is in subgroup s's list, i.e. among its
    first count ids.  Ids out of [0, n_tiles) are ignored, as the kernels
    ignore them."""
    ids = lists[:, 1:].long()
    pos = torch.arange(ids.shape[1], device=lists.device)
    keep = (pos[None, :] < lists[:, :1]) & (ids >= 0) & (ids < n_tiles)
    sel = torch.where(keep, ids, n_tiles)
    act = torch.zeros((lists.shape[0], n_tiles + 1), dtype=torch.bool,
                      device=lists.device)
    act.scatter_(1, sel, torch.ones_like(sel, dtype=torch.bool))
    return act[:, :n_tiles]


def _plain_pallas(rfT, fields, lists, eps_leaf, subg, closest):
    R, Tp = rfT.shape[1], fields.shape[1]
    listed = _listed_tiles(lists, Tp // TILE_T)
    slot_id = torch.arange(Tp, dtype=torch.int32, device=fields.device)
    ts, idxs = [], []
    for lo, hi in plain_chunks(R, Tp, subg):
        sg = torch.arange(lo, hi, device=fields.device) // subg
        on = listed[sg].repeat_interleave(TILE_T, dim=1)
        tval, _, _, ok = mt_slots(rfT, fields, eps_leaf, lo, hi)
        t = torch.where(on & ok, tval, INF32)
        tmin = t.amin(dim=1).clamp_max(INF32)
        ts.append(tmin)
        if closest:
            hit = tmin < INF32
            win = (t == tmin[:, None]) & hit[:, None]
            idx = torch.where(win, slot_id, _IDX_BIG).amin(dim=1)
            idxs.append(torch.where(hit, idx, 0))
    if closest:
        return torch.cat(ts), torch.cat(idxs)
    return torch.cat(ts)


def pallas_closest_plain(rfT, fields, lists, eps_leaf, subg):
    """Plain PyTorch B5: (t, idx) per ray.  t is the nearest valid hit over
    the tiles listed for the ray's subgroup (INF when none), idx the
    lowest triangle index at that t (0 on a miss)."""
    return _plain_pallas(rfT, fields, lists, eps_leaf, subg, True)


def pallas_shadow_plain(rfT, fields, lists, eps_leaf, subg):
    """Plain PyTorch B6: the nearest valid hit t per ray (INF when none)."""
    return _plain_pallas(rfT, fields, lists, eps_leaf, subg, False)


# --------------------------------------------------------- device dispatch

def dispatch(name, plain, *args):
    """Kernel ``name`` of ``ops/_kernels`` for a CUDA tensor, ``plain`` for
    a CPU tensor (the first argument decides)."""
    if _on_cuda(args[0]):
        from raytracinggpu_tpu_torch.ops import _kernels

        return getattr(_kernels, name)(*args)
    return plain(*args)


def pallas_closest(rfT, fields, lists, eps_leaf, subg):
    """B5 on the tensors' device: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    return dispatch("pallas_closest", pallas_closest_plain, rfT, fields,
                    lists, eps_leaf, subg)


def pallas_shadow(rfT, fields, lists, eps_leaf, subg):
    """B6 on the tensors' device (see pallas_closest)."""
    return dispatch("pallas_shadow", pallas_shadow_plain, rfT, fields, lists,
                    eps_leaf, subg)


# ------------------------------------------------------------ public queries

def cast_inputs(O: Vec3, u: Vec3, tab: PallasMeshTables, subg: int = SUBG,
                cap=None, sort_rays: bool = False):
    """The kernel inputs of one cast: (rfT (16, Rp), lists (Rp/subg,
    1 + n_tiles), perm, R) for the rays padded to Rp, a multiple of BLK_R,
    and sorted by ``perm`` when ``sort_rays`` (else perm is None);
    outputs past R (in sorted order: at perm's padding) are padding."""
    _check_subg(subg)
    O, u, cap, _, R = pad_rays(O, u, cap, BLK_R)
    perm = None
    if sort_rays:
        perm, O, u, extra = _sort_rays(O, u, () if cap is None else (cap,))
        cap = extra[0] if extra else None
    lists = _block_active_tiles(O, u, tab.tile_aabb, tab.n_tiles, cap=cap,
                                subg=subg)
    return _ray_features16(O, u), lists, perm, R


def intersect_tris_pallas(O: Vec3, u: Vec3, tab: PallasMeshTables,
                          eps_leaf: float, sort_rays: bool = True, cap=None,
                          subg: int = SUBG) -> TriHit:
    """Closest hit over the tiled mesh: TriHit(t, idx) with the BVH-order
    triangle index (no barycentrics: ``recompute_barycentrics``).

    sort_rays: group the rays into beam families before culling and
    scatter the results back; only the subgroups' composition changes.
    cap: (R,) upper bound on a useful hit distance (the nearest sphere
    hit); tiles entered beyond it are culled.  Hits at or below the cap
    are unchanged; a farther one may or may not be found (a ray tests
    every tile its subgroup keeps) and loses the caller's merge."""
    rfT, lists, perm, R = cast_inputs(O, u, tab, subg, cap, sort_rays)
    t, idx = pallas_closest(rfT, tab.fields, lists, eps_leaf, subg)
    if perm is not None:
        t, idx = _unsort(perm, t, idx)
    return TriHit(t=t[:R], idx=idx[:R])


def intersect_tris_shadow(O: Vec3, u: Vec3, tab: PallasMeshTables,
                          eps_leaf: float, cap=None, sort_rays: bool = True,
                          subg: int = SUBG):
    """Nearest mesh hit distance only (occlusion query); ``cap`` (R,), the
    distance to the light, culls tiles entirely beyond it."""
    rfT, lists, perm, R = cast_inputs(O, u, tab, subg, cap, sort_rays)
    t = pallas_shadow(rfT, tab.fields, lists, eps_leaf, subg)
    if perm is not None:
        (t,) = _unsort(perm, t)
    return t[:R]


def barycentrics_from_rows(O: Vec3, u: Vec3, g):
    """(beta, gamma) from a column accessor ``g(k)`` over gathered winner
    rows in fieldsT column order (0-14: Ng, e2 x A, e2, e1 x A, e1), the
    factorized MT recovery; sums rounded as XLA:CPU fuses them
    (``Vec3.dot``)."""
    w = O.cross(u)
    col = lambda k: Vec3(g(k), g(k + 1), g(k + 2))
    denom = u.dot(col(0))
    bnum = u.dot(col(3)) - w.dot(col(6))
    gnum = w.dot(col(12)) - u.dot(col(9))
    rden = 1.0 / denom
    return bnum * rden, gnum * rden


def recompute_barycentrics(O: Vec3, u: Vec3, tab: PallasMeshTables,
                           hit: TriHit):
    """(beta, gamma) of the winning triangle: one (R, 16) row gather."""
    rows = tab.fieldsT[hit.idx.long()]
    return barycentrics_from_rows(O, u, lambda k: rows[:, k])
