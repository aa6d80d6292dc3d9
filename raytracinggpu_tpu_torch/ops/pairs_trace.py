"""Pairs mesh traversal: cluster-packed tiles, per-subgroup culling
bitmask, and the two mesh queries of the main path (port of
``raytracinggpu_tpu/ops/pairs_trace.py``).

The host build is the JAX package's numpy code: the reference midpoint
BVH (or an auxiliary SAH tree, ``accel/sah.py``, whose order maps back to
the canonical ids) is cut into clusters of <= 128 triangles, the clusters
are packed into 128-slot tiles (greedily in Morton order, or ``pave``:
consecutive tree-order chunks at full occupancy), and every slot carries
32 field rows (0-15 the factorized Moller-Trumbore constants, 16 the original
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
the two agree bit for bit on the card.  The culling (``_pair_bits``) and
the ladder's key (``_compact_key``), XLA-side work in the JAX package,
dispatch the same way: the kernels of ``csrc/cull.cu`` for CUDA tensors,
``pair_bits_plain`` and ``compact_key_plain`` for CPU tensors, bit for
bit the same on the card.  So do the casts' glue, XLA-side work too: a
full-width cast's ray-feature rows (``_ray_feature_rows``, ``_live_rows``:
``ray_rows``) and a compacted cast's outputs scattered to full width
(``scatter``), the kernels of ``csrc/glue.cu`` for CUDA tensors, and a
compacted cast's rows at its source lanes with their culling
(``compact_bits``, one kernel of ``csrc/cull.cu``), the plain versions
for CPU tensors.  The slab test, the ray padding, the ray
rows, the plain Moller-Trumbore core and the device dispatch are the
tiled traversal's (``ops/pallas_trace.py``), as in the JAX package.

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

The compaction ladder (the JAX package's default at depth >= 1; ``compact``,
``compact2``, ``compact3`` and ``key_coarse`` of the two queries): a cast
keys each ray by the first and last tile box it hits (``_compact_key``),
reads the count of rays that hit any, and when the tightest tier of
``_compact_tiers`` holds them, sorts the keys and runs the kernel on those
C rays only (grouped by their tile span, so a subgroup's union stays
tight; ``compact_bits`` builds their rows from the sorted keys and culls
them), and ``scatter`` writes each lane its result or the no-hit default;
a cast that overflows every tier runs at full width and sorts nothing.
The compacted cast re-runs the exact member culling on its rays, so every
ray's hit within its ``cap`` is the full-width cast's bit for bit.  XLA
chooses the tier on the device (``lax.cond``); here the host reads the
count, once a cast.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pallas_trace import (
    INF32,
    TILE_T,
    _on_cuda,
    dispatch,
    mt_slots,
    pad_rays,
    plain_chunks,
    ray_rows,
    ray_rows_plain,
    slab_enter_exit,
)
from raytracinggpu_tpu_torch.ops.triangle import TriHit
from raytracinggpu_tpu_torch.utils.profiling import count, span

NUM_FIELDS = 32       # rows 0-15: MT constants; 16: original tri id;
                      # 17-25: vertex normals na/nb/nc; 26-31: pad
DEF_BLK = 4096        # ray padding granularity (RenderConfig.pairs_block)
DEF_SUBG = 16         # rays per culling subgroup
_IDX_BIG = np.int32(2**30)  # id of padding slots
# the outputs of a cast's kernels on a lane that hits nothing: (t, idx,
# N.x, N.y, N.z), the shadow cast's t the first; a compacted cast's
# skipped lanes get them
NO_HIT = (INF32, 0, 0.0, 0.0, 0.0)
_BOX_BATCH = 512      # boxes a slab test holds at once
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

def _cluster_slots(bvh, n_tri: int, tile_t: int = TILE_T,
                   cut_tris: int | None = None, ids_map=None,
                   pack: str = "morton"):
    """Host: cluster ranges -> (slot_src (nc*tile_t,), nc, members).

    The cluster cut (shallowest subtrees <= tile_t tris) is packed into
    tiles by ``pack``:

    - ``morton``: whole clusters, greedily in Morton order of the cluster
      box centers, first-fit within a window of recent tiles and under a
      box-growth bound, so spatial neighbours merge and the union boxes
      stay tight;
    - ``pave``: consecutive tree-order triangle ranges at 100% occupancy:
      tiles are exact tile_t-wide chunks of the cut order, and a cluster
      that straddles a tile boundary splits into one member per side
      (member boxes are refit from their triangles, so a split only
      tightens the culling).  Merging tiles only clears activation bits,
      so at a fixed visit width full occupancy minimizes the pairs for a
      given triangle order.

    ids_map: optional (T,) permutation from the cut tree's triangle
    positions to positions in the A/B/C arrays, so that the cut can run
    over an auxiliary tree (``accel/sah.py``) while the slot ids stay in
    the canonical mesh order.  Packed tiles are not ascending in original
    id, which is why the closest hit breaks exact-t ties lexicographically
    on (t, original id); any clustering that covers every triangle
    therefore renders bit-identically."""
    from raytracinggpu_tpu_torch.accel.bvh import cluster_cut
    from raytracinggpu_tpu_torch.accel.lbvh import morton_codes

    if pack not in ("morton", "pave"):
        raise ValueError(f"unknown pairs packing {pack!r}; choose from "
                         "('morton', 'pave')")
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
    if pack == "pave":
        groups: list[list[tuple[int, int, int]]] = []  # (ci, s, e) pieces
        cur: list[tuple[int, int, int]] = []
        cap = tile_t
        for ci in range(len(cut.starts)):
            s, e = int(cut.starts[ci]), int(cut.ends[ci])
            while s < e:
                take = min(e - s, cap)
                cur.append((ci, s, s + take))
                cap -= take
                s += take
                if cap == 0:
                    groups.append(cur)
                    cur, cap = [], tile_t
        if cur:
            groups.append(cur)
    else:
        centers = (cut.mn + cut.mx) * 0.5
        order = np.argsort(morton_codes(centers), kind="stable")
        WINDOW = 8
        mesh_vol = float(np.prod(cut.mx.max(axis=0) - cut.mn.min(axis=0)))
        MAX_TILE_VOL = 0.02 * mesh_vol * (tile_t / 128.0)
        packed: list[list] = []  # [cluster ids, size, mn(3,), mx(3,)]
        for ci in order:
            size = int(cut.ends[ci] - cut.starts[ci])
            placed = False
            for g in packed[-WINDOW:]:
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
                packed.append([[ci], size, cut.mn[ci].copy(),
                               cut.mx[ci].copy()])
        groups = [[(ci, int(cut.starts[ci]), int(cut.ends[ci]))
                   for ci in g[0]] for g in packed]
    nc = len(groups)
    if ids_map is None:
        ids_map = np.arange(n_tri, dtype=np.int32)
    slot_src = np.full(nc * tile_t, -1, np.int32)
    member_slot = np.full(nc * tile_t, -1, np.int32)
    member_tile: list[int] = []
    member_aabb_rows: list[np.ndarray] = []
    for j, pieces in enumerate(groups):
        k = j * tile_t
        for ci, s, e in pieces:
            m = len(member_tile)
            member_tile.append(j)
            row = np.zeros(8, np.float32)
            row[0:3], row[3:6] = cut.mn[ci], cut.mx[ci]
            member_aabb_rows.append(row)
            slot_src[k : k + (e - s)] = ids_map[s:e]
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


def _cross_rows(a, b):
    """a x b of (3, n) row stacks, each component a*b' - c*d' with every
    product rounded, as ``np.cross`` rounds it."""
    return torch.stack([a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def mt_rows(a, b, c) -> torch.Tensor:
    """(16, n) Moller-Trumbore rows [Ng, e2 x A, e2, e1 x A, e1, A.Ng] of
    the (3, n) corner stacks a, b, c, every product and sum rounded as
    the numpy table builds round them (A.Ng summed left to right, as
    numpy's ``sum`` and ``einsum`` add three products)."""
    e1, e2 = b - a, c - a
    ng = _cross_rows(e1, e2)
    p = a * ng
    return torch.cat([ng, _cross_rows(e2, a), e2, _cross_rows(e1, a), e1,
                      ((p[0] + p[1]) + p[2])[None]])


def fields_from_corners_torch(A, B, C, slot_src, na, nb,
                              nc) -> torch.Tensor:
    """``fields_from_corners`` on the device: A, B, C and the vertex
    normals are (3, T) row stacks, slot_src the (Tc,) int32 slot map.
    The same corners give the same table bit for bit."""
    live = slot_src >= 0
    idx = slot_src.clamp_min(0).long()
    g = lambda v: torch.where(live, v[:, idx], 0.0)
    f = torch.cat([mt_rows(g(A), g(B), g(C)),
                   torch.where(live, slot_src, int(_IDX_BIG)).to(A.dtype)[None],
                   g(na), g(nb), g(nc)])
    return F.pad(f, (0, 0, 0, NUM_FIELDS - f.shape[0]))


def build_pairs_tables(A, B, C, bvh, device, tile_t: int = TILE_T, vna=None,
                       vnb=None, vnc=None, cut_tris: int | None = None,
                       ids_map=None, pack: str = "morton") -> PairsMeshTables:
    """Host-side build from BVH-ordered triangle corners (T, 3); the tables
    land on ``device``.  cut_tris (the cluster-cut granularity), ids_map
    (an auxiliary cluster tree's slot remap) and pack (``morton`` or
    ``pave``) are clustering knobs (see ``_cluster_slots``); results do
    not depend on them.  Raises PairsMeshTooLarge past MAX_SLOTS slots."""
    if tile_t <= 0 or tile_t % 32:
        raise ValueError(f"tile_t must be a positive multiple of 32, got {tile_t}")
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    slot_src, nc, (m_aabb, m_tile, m_slot) = _cluster_slots(
        bvh, A.shape[0], tile_t, cut_tris=cut_tris, ids_map=ids_map,
        pack=pack)
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

def pair_bits_plain(O, u, nc, subg, members, cap=None, active=None):
    """Plain PyTorch culling to a packed per-subgroup active-tile bitmask:
    (W, R/subg) int32, bit j of word (w, sg) set iff tile 32w+j is active
    for subgroup sg.  A member box is active for a ray when the ray's slab
    interval hits it (and enters it no later than ``cap``, for rays in
    ``active``); a tile is active for a subgroup when any ray of the
    subgroup activates any of its member boxes.  Bit 31 is the int32 sign
    bit (two's complement)."""
    boxes, member_tile = members
    R = O.x.shape[0]
    S = R // subg
    W = -(-nc // 32)
    nb = boxes.shape[0]
    # batch the slab tests over boxes: the (nb, R) intermediates would
    # otherwise grow with the mesh
    mi = torch.zeros((nc, S), dtype=torch.int32, device=O.x.device)
    for b0 in range(0, nb, _BOX_BATCH):
        bs = boxes[b0 : b0 + _BOX_BATCH]
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


def _pair_bits(O, u, nc, subg, members, cap=None, active=None):
    """The culling bitmask of ``pair_bits_plain`` on the rays' device: the
    kernel of ``csrc/cull.cu`` (``_kernels.pair_bits``) for CUDA tensors,
    the plain version for CPU tensors."""
    if _on_cuda(O.x):
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.pair_bits(O, u, nc, subg, members, cap, active)
    return pair_bits_plain(O, u, nc, subg, members, cap, active)


def _ray_feature_rows(O: Vec3, u: Vec3) -> torch.Tensor:
    """(16, R) ray-feature rows of a full-width cast: [u(3), w=O x u(3),
    O(3), 0-pad] (``ray_rows``: the kernel ``rt_ray_rows`` on CUDA
    tensors)."""
    return ray_rows(O, u)


# ------------------------------------------------------ the compaction ladder

def _key_mode(nc: int, R: int) -> tuple[int, int]:
    """(mode, shift) of the int32 sort key (group_key << shift) | lane.

    mode 2: group key first_tile * (nc+1) + last_tile (rays sharing both
    ends of their active-tile span group together); mode 1: first_tile,
    when the pairwise key and the lane no longer fit an int32; mode 0:
    compaction off (not even the single key fits).  The inactive marker
    is the mode's all-ones key, so inactive lanes sort behind every
    active ray."""
    for mode, bits in ((2, ((nc + 1) * (nc + 1) - 1).bit_length()),
                       (1, int(nc).bit_length())):
        shift = 31 - bits
        if shift >= 0 and R <= (1 << shift):
            return mode, shift
    return 0, 0


def key_boxes(n_tiles: int, key_coarse: int) -> int:
    """The boxes the ladder's key runs over (``_ladder_tiers``): the
    n_tiles tile boxes, or their unions of ``key_coarse``."""
    return n_tiles if key_coarse <= 1 else -(-n_tiles // key_coarse)


def key_lanes(n_tiles: int, key_coarse: int) -> int:
    """The most lanes of a cast that the ladder's key holds in any mode:
    ``1 << shift`` of ``_key_mode``'s mode 1 (the first box alone) over
    the key boxes (``key_boxes``), which holds more lanes than mode 2."""
    return 1 << (31 - key_boxes(n_tiles, key_coarse).bit_length())


def _coarse_aabb(aabb, nc: int, g: int):
    """((ng, 8) union boxes of g consecutive tiles, the last group padded
    with the last tile's box; ng), for the key only.  A union box is hit
    wherever one of its tiles is, so the coarse activity is a superset of
    the per-tile one and the ladder stays exact."""
    ng = -(-nc // g)
    a = aabb[:nc]
    if ng * g != nc:
        a = torch.cat([a, a[-1:].expand(ng * g - nc, a.shape[1])])
    a = a.reshape(ng, g, a.shape[1])
    return torch.cat([a[:, :, 0:3].amin(dim=1), a[:, :, 3:6].amax(dim=1),
                      a.new_zeros((ng, a.shape[2] - 6))], dim=1), ng


def compact_key_plain(O, u, aabb, nc, cap, active, valid_n):
    """Plain PyTorch: the ladder's sort key and active count: (skey (R,)
    int32, n_act (0-d int64), shift).

    A ray is active when its slab interval hits one of the nc boxes
    (entering no later than ``cap``, where ``active`` holds); lanes past
    ``valid_n`` (the padding) never are.  Its key is the first (and in
    mode 2 the last) box it hits, an inactive ray's the mode's inactive
    marker, shifted over the lane id, so that the keys are distinct and
    their low ``shift`` bits are the gather indices."""
    R = O.x.shape[0]
    mode, shift = _key_mode(nc, R)
    dev = O.x.device
    first = torch.full((R,), nc, dtype=torch.int32, device=dev)
    last = torch.full((R,), -1, dtype=torch.int32, device=dev)
    for b0 in range(0, nc, _BOX_BATCH):  # bounds the (boxes, R) slabs
        enter, _exit, hit = slab_enter_exit(O, u, aabb[b0:b0 + _BOX_BATCH])
        if cap is not None:
            hit = hit & (enter <= cap[None, :])
        if active is not None:
            hit = hit & active[None, :]
        tid = torch.arange(b0, b0 + hit.shape[0], dtype=torch.int32,
                           device=dev)[:, None]
        last = torch.maximum(last, torch.where(hit, tid, -1).amax(dim=0))
        first = torch.minimum(first, torch.where(hit, tid, nc).amin(dim=0))
    lane = torch.arange(R, dtype=torch.int32, device=dev)
    act = (last >= 0) & (lane < valid_n)
    if mode == 2:
        key, inactive = first * (nc + 1) + last, (nc + 1) * (nc + 1) - 1
    else:
        key, inactive = first, nc
    key = torch.where(act, key, inactive)
    return (key << shift) | lane, act.sum(), shift


def _compact_key(O, u, aabb, nc, cap, active, valid_n):
    """The key of ``compact_key_plain`` on the rays' device: the kernel of
    ``csrc/cull.cu`` (``_kernels.compact_key``) for CUDA tensors, whose
    n_act stays on the card, the plain version for CPU tensors."""
    if _on_cuda(O.x):
        from raytracinggpu_tpu_torch.ops import _kernels

        mode, shift = _key_mode(nc, O.x.shape[0])
        skey, n_act = _kernels.compact_key(O, u, aabb, nc, mode, shift, cap,
                                           active, valid_n)
        return skey, n_act, shift
    return compact_key_plain(O, u, aabb, nc, cap, active, valid_n)


class Compaction(NamedTuple):
    """A compacted cast: its rays' keys sorted, (Rp,) int32; its width C
    (the tier taken) and the key's ``shift``.  The first C keys' low
    ``shift`` bits are the cast's source lanes: the active rays grouped by
    key, then inactive lanes.  The keys are distinct and hold every lane
    once, so the sorted keys are a permutation of the lanes."""

    keys: torch.Tensor
    C: int
    shift: int


def _compact_sort(skey, C: int, shift: int) -> Compaction:
    """The sort of a compacted cast, the one place it runs: the keys are
    distinct, so an unstable sort gives the one order."""
    return Compaction(torch.sort(skey).values, C, shift)


def _compact_src(O, u, aabb, nc, cap, active, C, valid_n):
    """Key and sort in one step: (src (C,) int32, n_act)."""
    skey, n_act, shift = _compact_key(O, u, aabb, nc, cap, active, valid_n)
    keys = _compact_sort(skey, C, shift).keys
    return keys[:C] & ((1 << shift) - 1), n_act


def _compact_ok(compact: float, nc: int, R: int, blk: int) -> int:
    """Compact capacity C (rounded up to whole blocks), or 0 when the
    fraction is 0, the key and the lane cannot share an int32
    (``_key_mode``) or C would not be below R."""
    if not compact or not _key_mode(nc, R)[0]:
        return 0
    C = -(-int(R * compact) // blk) * blk
    return C if C < R else 0


def _compact_tiers(fractions, nc: int, R: int, blk: int) -> list:
    """The ladder: the strictly ascending capacities of the fractions that
    give one (in any order; zeros, duplicates and capacities that fail
    ``_compact_ok`` drop out)."""
    tiers: list = []
    for f in sorted(float(x) for x in fractions if x):
        C = _compact_ok(f, nc, R, blk)
        if C and (not tiers or C > tiers[-1]):
            tiers.append(C)
    return tiers


def _count_pending(n_act):
    """Start the host's read of a cast's active count: on a card, a
    non-blocking copy into pinned memory and an event after it, so that
    the host can queue more work before it waits (``_tier``)."""
    if n_act.device.type != "cuda":
        return n_act, None
    host = torch.empty((), dtype=n_act.dtype, pin_memory=True)
    host.copy_(n_act, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(n_act.device))
    return host, done


def _tier(tiers, pending) -> int:
    """The tightest tier that holds the active count, 0 when none does
    (the cast then runs at full width); waits for the count (``pending``:
    ``_count_pending``'s).  While tracing is on, the wait is the span
    ``ladder.wait`` (its attribute the count) and the counters
    ``ladder.casts``, ``ladder.wait_ns``, and over the casts that take a
    tier ``ladder.compacted``, ``ladder.active`` (the counts) and
    ``ladder.capacity`` (the tiers)."""
    host, done = pending
    with span("ladder.wait") as wait:
        if done is not None:
            done.synchronize()
        n = int(host)
        wait.set_attr(n)
    C = next((C for C in tiers if n <= C), 0)
    count("ladder.casts")
    count("ladder.wait_ns", wait.ns)
    if C:
        count("ladder.compacted")
        count("ladder.active", n)
        count("ladder.capacity", C)
    return C


# the union boxes of each table's tile boxes, per key_coarse, built once a
# table (tables are never written in place: a posed mesh gets new ones)
_COARSE = WeakIdKeyDictionary()


def _ladder_tiers(tab, fractions, key_coarse: int, Rp: int, blk: int):
    """(tiers, key boxes, their count) of an Rp-ray cast: the key runs over
    the tile boxes, or over unions of ``key_coarse`` of them."""
    nc = tab.tile_aabb.shape[0]
    if key_coarse <= 1:
        return _compact_tiers(fractions, nc, Rp, blk), tab.tile_aabb, nc
    per_table = _COARSE.setdefault(tab.tile_aabb, {})
    if key_coarse not in per_table:
        per_table[key_coarse] = _coarse_aabb(tab.tile_aabb, nc, key_coarse)
    boxes, knc = per_table[key_coarse]
    return _compact_tiers(fractions, knc, Rp, blk), boxes, knc


def _live_rows(O, u, cap, active) -> torch.Tensor:
    """The rows a cast's rays carry: [u, w, O], then ``cap`` (row 9) and
    the shadow mask (row 10, 1.0 where active) when given (``ray_rows``
    in the ``live`` layout)."""
    return ray_rows(O, u, cap, active, layout="live")


def compact_rows_plain(keys, C: int, shift: int, O, u, cap=None,
                       active=None):
    """Plain PyTorch: the rows of a compacted cast: (rows, src, active)
    with src the C source lanes of the sorted ``keys`` (``Compaction``),
    (C,) int32, rows the live rows (``_live_rows``) of those lanes, (9-11,
    C) f32, and active their shadow mask, (C,) bool, or None without
    one."""
    src = keys[:C] & ((1 << shift) - 1)
    rows = ray_rows_plain(O, u, cap, active, "live").index_select(
        1, src.long())
    return rows, src, None if active is None else rows[10] > 0.5


def compact_bits_plain(keys, C: int, shift: int, O, u, nc: int, subg: int,
                       members, cap=None, active=None):
    """Plain PyTorch: a compacted cast's kernel inputs (the contract of the
    kernel ``rt_compact_bits``): (rows, active, bits), the rows and shadow
    mask of ``compact_rows_plain`` and ``pair_bits_plain`` of the C rays
    they hold (O rows 6-8, u rows 0-2, cap row 9 where given, the mask),
    the culling again, exactly, on the C rays."""
    rows, _, act = compact_rows_plain(keys, C, shift, O, u, cap, active)
    bits = pair_bits_plain(Vec3(rows[6], rows[7], rows[8]),
                           Vec3(rows[0], rows[1], rows[2]), nc, subg,
                           members, None if cap is None else rows[9], act)
    return rows, act, bits


def compact_bits(keys, C: int, shift: int, O, u, nc: int, subg: int,
                 members, cap=None, active=None):
    """``compact_bits_plain`` on the rays' device: the kernel
    ``rt_compact_bits`` of ``csrc/cull.cu`` for CUDA tensors, which gathers
    the C rays, writes their rows and culls them in one launch, the plain
    version for CPU tensors."""
    if _on_cuda(O.x):
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.compact_bits(keys, C, shift, O, u, nc, subg, members,
                                     cap, active)
    return compact_bits_plain(keys, C, shift, O, u, nc, subg, members, cap,
                              active)


def scatter_plain(keys, C: int, shift: int, outs, defaults):
    """Plain PyTorch: a compacted cast's outputs at full width (the
    contract of the kernel ``rt_scatter``): each (Rp,) output holds the
    cast's (C,) output at its source lanes (``Compaction``) and its
    default (the kernel's no-hit result) on the lanes the cast skipped."""
    Rp = keys.shape[0]
    src = (keys[:C] & ((1 << shift) - 1)).long()
    return [torch.full((Rp,), d, dtype=o.dtype, device=o.device)
            .index_copy_(0, src, o) for o, d in zip(outs, defaults)]


def scatter(keys, C: int, shift: int, outs, defaults):
    """``scatter_plain`` on the keys' device: the kernel ``rt_scatter`` of
    ``csrc/glue.cu`` for CUDA tensors, one launch for every output, the
    plain version for CPU tensors."""
    if _on_cuda(keys):
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.scatter(keys, C, shift, outs, defaults)
    return scatter_plain(keys, C, shift, outs, defaults)


def _ladder(O, u, tab, subg, cap, active, fractions, key_coarse, blk,
            valid_n):
    """The kernel inputs of one cast under the ladder: (rf, bits, plan), or
    None when the fractions give no tier (the cast is the plain
    full-width one).

    plan is None when the cast runs at full width on all of its rays (rf
    its live rows, ``_live_rows``, bits their culling), else its
    ``Compaction``, rf the live rows of its C source lanes and bits their
    culling (``compact_bits``, one launch).

    While tracing is on, the span ``ladder`` (its attribute C, 0 at full
    width) holds ``ladder.key`` (the key and the count's copy; its
    attribute the cast's padded rays), ``ladder.wait`` (``_tier``), then
    ``ladder.sort`` and ``ladder.bits``, or ``cast.rows_bits``; the
    counter ``ladder.key_mode1`` adds one a compacted cast whose key took
    mode 1 (``_key_mode``: a cast wider than mode 2 holds)."""
    Rp = O.x.shape[0]
    tiers, boxes, knc = _ladder_tiers(tab, fractions, key_coarse, Rp, blk)
    if not tiers:
        return None
    with span("ladder") as ladder:
        with span("ladder.key", Rp):
            skey, n_act, shift = _compact_key(O, u, boxes, knc, cap, active,
                                              valid_n)
            pending = _count_pending(n_act)
        C = _tier(tiers, pending)
        ladder.set_attr(C)
        if not C:
            with span("cast.rows_bits"):
                return (_live_rows(O, u, cap, active),
                        _bits(O, u, tab, subg, cap, active), None)
        count("ladder.key_mode1", int(_key_mode(knc, Rp)[0] == 1))
        with span("ladder.sort"):
            plan = _compact_sort(skey, C, shift)
        with span("ladder.bits"):
            rf, _, bits = compact_bits(*plan, O, u, tab.tile_aabb.shape[0],
                                       subg,
                                       (tab.member_aabb, tab.member_tile),
                                       cap, active)
        return rf, bits, plan


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
    rfT, bits, _, R = _rows_bits(O, u, tab, subg, blk, cap, active, (), 1)
    return rfT, bits, R


def _bits(O, u, tab, subg, cap=None, active=None):
    return _pair_bits(O, u, tab.tile_aabb.shape[0], subg,
                      (tab.member_aabb, tab.member_tile), cap=cap,
                      active=active)


def _rows_bits(O, u, tab, subg, blk, cap, active, fractions, key_coarse):
    """(rfT, bits, plan, R) of one cast: the kernel's inputs on the rays
    the ladder keeps (plan None: all of them, padded to a multiple of
    blk; else the cast's ``Compaction``), and the rays' count unpadded."""
    O, u, cap, active, R = pad_rays(O, u, cap, blk, active)
    ladder = _ladder(O, u, tab, subg, cap, active, fractions, key_coarse,
                     blk, R)
    if ladder is None:
        with span("cast.rows_bits"):
            return (_ray_feature_rows(O, u),
                    _bits(O, u, tab, subg, cap, active), None, R)
    return (*ladder, R)


def intersect_tris_pairs(O: Vec3, u: Vec3, tab: PairsMeshTables,
                         eps_leaf: float, cap=None, subg: int = DEF_SUBG,
                         blk: int = DEF_BLK, payload: str | None = None,
                         compact: float = 0.0, compact2: float = 0.0,
                         compact3: float = 0.0, key_coarse: int = 1):
    """Closest hit over the cluster-tiled mesh: TriHit with the ORIGINAL
    (BVH-order) triangle index.  ``cap`` (R,) culls tiles the ray enters
    beyond it (the caller's nearest sphere hit).

    payload: None | "geom" | "smooth".  When set, the kernel also tracks
    the winner's normal (geometric Ng, or the Phong-interpolated vertex
    normal from field rows 17-25) and the return becomes (TriHit, N), N
    unnormalized.

    compact, compact2, compact3: the compaction ladder's fractions of the
    cast (0 drops a tier; all 0, the default, is the full-width cast),
    key_coarse the tiles a box of its key.  The result is the full-width
    cast's on every lane whose t is at most ``cap`` there: such a hit lies
    in a tile the ray itself enters before ``cap``.  Past ``cap`` the two
    may differ (a lane whose every tile lies past ``cap`` is not active;
    at full width a subgroup-mate's tiles can still give it a hit), but
    both give a t above ``cap`` or INF.  The integrator, which keeps the
    nearer of the mesh's t and the sphere's ``cap``, sees no difference."""
    kernel = {None: pairs_closest_idx, "geom": pairs_closest,
              "smooth": pairs_closest_smooth}[payload]
    rfT, bits, plan, R = _rows_bits(O, u, tab, subg, blk, cap, None,
                                    (compact, compact2, compact3),
                                    key_coarse)
    with span("cast.kernel", rfT.shape[1]):
        out = kernel(rfT, tab.fields, bits, eps_leaf, subg, tile_width(tab))
    if plan is not None:
        with span("ladder.scatter"):
            out = scatter(*plan, out, NO_HIT[:len(out)])
    out = [o[:R] for o in out]
    hit = TriHit(t=out[0], idx=out[1])
    return (hit, Vec3(*out[2:])) if payload else hit


def intersect_tris_pairs_shadow(O: Vec3, u: Vec3, tab: PairsMeshTables,
                                eps_leaf: float, cap=None,
                                subg: int = DEF_SUBG, blk: int = DEF_BLK,
                                active=None, compact: float = 0.0,
                                compact2: float = 0.0, compact3: float = 0.0,
                                key_coarse: int = 1):
    """Nearest mesh hit distance only (occlusion query; ``cap`` = |L-P|
    culls tiles beyond the light).  ``active`` (R,) bool: lanes whose
    occlusion result is unused contribute no culling bits; a lane whose
    whole subgroup is inactive returns INF, and under the ladder every
    inactive lane may (the integrator reads none of them).  The ladder's
    arguments and its contract as in ``intersect_tris_pairs``: the same t
    on every active lane whose full-width t is at most ``cap``."""
    rfT, bits, plan, R = _rows_bits(O, u, tab, subg, blk, cap, active,
                                    (compact, compact2, compact3),
                                    key_coarse)
    with span("cast.kernel", rfT.shape[1]):
        t = pairs_shadow(rfT, tab.fields, bits, eps_leaf, subg,
                         tile_width(tab))
    if plan is not None:
        with span("ladder.scatter"):
            t = scatter(*plan, (t,), NO_HIT[:1])[0]
    return t[:R]
