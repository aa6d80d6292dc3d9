"""The port's hand-written CUDA kernels and their wrappers
(raytracinggpu_tpu_torch/ops/_kernels.py, the ops/pairs_trace.py and
ops/pallas_trace.py dispatch).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The cases marked ``cuda`` need a CUDA device and nvcc; they build the
kernels and hold each one (B0-B3, B5, B6, and the probes B7a-e of
bench/micro_kernel.py) bit for bit against its plain PyTorch version (the
kernels are compiled with --fmad=false, so every product and sum rounds
as PyTorch's eager ops round it).  Without a device
they skip.  The other cases check the plain versions against brute force
and against each other, and the wrappers' dispatch and input checks, on
the CPU.
"""
import math
import re

import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.core.rng import cosine_hemisphere
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.integrator.wavefront import intersect_all
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pairs_trace as pt
from raytracinggpu_tpu_torch.ops import pallas_trace as pat
from raytracinggpu_tpu_torch.ops.sphere import intersect_spheres
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

SUBG, BLK, EPS = 64, 4096, 1e-4
KINDS = ("camera", "scattered", "depth1")
# closest-hit wrappers: (name, payload of intersect_tris_pairs, outputs)
CLOSEST = (("pairs_closest", "geom", 5), ("pairs_closest_smooth", "smooth", 5),
           ("pairs_closest_idx", None, 2))


@pytest.fixture(scope="module")
def scene():
    return build_preset("array_bvh", "cpu")


def _rays(kind, cfg, tables, R, seed=0):
    """(O, u) Vec3 on the CPU: a fan from the camera, random rays inside
    the box, or diffuse bounce rays leaving the primary hits."""
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        O = rng.uniform(-25, 25, (3, R)).astype(np.float32)
    else:
        O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, R))
    d = rng.normal(size=(3, R)).astype(np.float32)
    if kind != "scattered":
        d[2] = -np.abs(d[2]) * 4.0 - 2.0  # toward the cat
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = Vec3(*(torch.from_numpy(c.copy()) for c in O))
    u = Vec3(*(torch.from_numpy(c.copy()) for c in d))
    if kind == "depth1":
        h = intersect_all(tables, cfg, O, u)
        r = torch.from_numpy((1.0 - rng.random((2, R))).astype(np.float32))
        u = cosine_hemisphere(r[0], r[1], h.N)
        O = h.N.fma(1e-4, h.P)
    return O, u


def _cast(scene, kind, R, device, seed=0, shadow=False, capped=True):
    cfg, tables = scene
    O, u = _rays(kind, cfg, tables, R, seed)
    O = Vec3(*(c.to(device) for c in O))
    u = Vec3(*(c.to(device) for c in u))
    tab = pt.PairsMeshTables(*(t.to(device) for t in tables.pairs_mesh))
    spheres = type(tables.spheres)(*(c.to(device) for c in tables.spheres))
    cap = intersect_spheres(O, u, spheres)[0] if capped else None
    active = None
    if shadow:
        g = torch.Generator().manual_seed(seed)
        active = (torch.rand(R, generator=g) < 0.6).to(device)
    rfT, bits, _ = pt.cast_inputs(O, u, tab, SUBG, BLK, cap=cap,
                                  active=active)
    return tab, O, u, cap, active, rfT, bits


# ------------------------------------------------------------- CPU cases

def _exact_against_brute_force(scene, name, n_out):
    tab, _, _, _, _, rfT, bits = _cast(scene, "camera", 2048, "cpu", seed=8,
                                       capped=False)
    all_on = torch.full_like(bits, -1)
    plain = getattr(pt, f"{name}_plain")
    got = plain(rfT, tab.fields, bits, EPS, SUBG, 128)
    want = plain(rfT, tab.fields, all_on, EPS, SUBG, 128)
    assert len(got) == n_out
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[0] < pt.INF32).sum() > 100


def test_plain_closest_is_exact_against_brute_force(scene):
    """Culling is exact: the plain version over the culled tiles finds the
    same nearest hit as Moller-Trumbore over every slot."""
    _exact_against_brute_force(scene, "pairs_closest", 5)


@pytest.mark.parametrize("name,payload,n_out", CLOSEST[1:])
def test_plain_smooth_and_idx_are_exact_against_brute_force(scene, name,
                                                            payload, n_out):
    """The same for B3 (its payload included) and B0."""
    _exact_against_brute_force(scene, name, n_out)


def test_plain_closest_versions_agree(scene):
    """B0, B1 and B3 pick the same (t, idx); B3's N is the winner's
    vertex normals weighted by its barycentrics, a unit-length blend of
    unit normals here (the cat's OBJ normals), and points the way Ng
    does on almost every hit."""
    tab, _, _, _, _, rfT, bits = _cast(scene, "depth1", 4096, "cpu", seed=2)
    args = (rfT, tab.fields, bits, EPS, SUBG, 128)
    b1 = pt.pairs_closest_plain(*args)
    b3 = pt.pairs_closest_smooth_plain(*args)
    b0 = pt.pairs_closest_idx_plain(*args)
    for a, b, c in zip(b0, b1, b3):
        assert torch.equal(a, b) and torch.equal(a, c)
    hit = b1[0] < pt.INF32
    assert hit.sum() > 100
    ns = torch.stack(b3[2:])[:, hit]
    ng = torch.stack(b1[2:])[:, hit]
    assert (ns.norm(dim=0) > 0.5).all() and (ns.norm(dim=0) < 1.01).all()
    assert ((ns * ng).sum(dim=0) > 0).float().mean() > 0.95
    assert all((c[~hit] == 0).all() for c in b3[2:])


def test_cpu_tensors_run_the_plain_versions(scene):
    tab, _, _, _, _, rfT, bits = _cast(scene, "camera", 4096, "cpu")
    before = dict(_kernels.LAUNCHES)
    for name, _, _ in CLOSEST:
        got = getattr(pt, name)(rfT, tab.fields, bits, EPS, SUBG, 128)
        want = getattr(pt, f"{name}_plain")(rfT, tab.fields, bits, EPS,
                                            SUBG, 128)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert torch.equal(pt.pairs_shadow(rfT, tab.fields, bits, EPS, SUBG, 128),
                       pt.pairs_shadow_plain(rfT, tab.fields, bits, EPS,
                                             SUBG, 128))
    assert _kernels.LAUNCHES == before  # nothing was launched
    t, idx, nx, ny, nz = got = pt.pairs_closest_smooth(
        rfT, tab.fields, bits, EPS, SUBG, 128)
    miss = t >= pt.INF32
    assert miss.any() and (~miss).any()
    assert (idx[miss] == 0).all() and (nx[miss] == 0).all()
    assert idx.dtype == torch.int32 and t.dtype == torch.float32


def test_other_devices_raise():
    x = torch.empty(4, device="meta")
    with pytest.raises(ValueError):
        pt.pairs_shadow(x, x, x, EPS, SUBG, 128)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "bits", "tiles",
                                 "rows"])
def test_kernel_wrappers_check_their_inputs(bad):
    """Every pairs wrapper refuses what its kernel does not take; B3 reads
    the vertex-normal rows 17-25, so it needs 26 field rows where the
    others need 17.  (The tiled wrappers: test_tiled_wrappers_check_*.)"""
    R, Tc = 256, 256
    rfT = torch.zeros(16, R)
    fields = torch.zeros(32, Tc)
    bits = torch.zeros(1, R // SUBG, dtype=torch.int32)
    names = [n for n in _kernels.LAUNCHES if n.startswith("pairs_")]
    if bad == "dtype":
        fields = fields.double()
    elif bad == "contiguity":
        rfT = torch.zeros(R, 16).T
    elif bad == "bits":
        bits = torch.zeros(1, R // SUBG + 1, dtype=torch.int32)
    elif bad == "tiles":
        fields = torch.zeros(32, Tc + 32)
    else:
        fields = torch.zeros(25, Tc)
        names = ["pairs_closest_smooth"]
    assert set(_kernels.LAUNCHES) == {"pairs_closest", "pairs_shadow",
                                      "pairs_closest_smooth",
                                      "pairs_closest_idx", "pallas_closest",
                                      "pallas_shadow", *_kernels.PROBES,
                                      "pair_bits", "compact_key",
                                      "tile_lists", "compact_bits",
                                      *_kernels.DEPTH_STEP, *_kernels.GLUE}
    for name in names:
        with pytest.raises(ValueError):
            getattr(_kernels, name)(rfT, fields, bits, EPS, SUBG, 128)


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _kernels.find_nvcc()


def _tie_table():
    """Two tiles holding the same triangle (z = 0, facing +z) under the
    original ids 7 (tile 0) and 3 (tile 1), and 128 rays straight down on
    it: every ray hits both slots at the same t."""
    T = 8
    A = np.full((T, 3), 50.0, np.float32)
    B, C = A + np.float32([1, 0, 0]), A + np.float32([0, 1, 0])
    for i in (3, 7):
        A[i], B[i], C[i] = (-10, -10, 0), (10, -10, 0), (-10, 10, 0)
    slot_src = np.full(256, -1, np.int32)
    slot_src[0], slot_src[128] = 7, 3
    n = np.tile(np.float32([0, 0, 1]), (T, 1))  # vertex normals, for B3
    fields = torch.from_numpy(pt.fields_from_corners(A, B, C, slot_src,
                                                     n, n, n))
    xy = np.random.default_rng(0).uniform(-8, 0, (2, 128)).astype(np.float32)
    O = Vec3(torch.from_numpy(xy[0]), torch.from_numpy(xy[1]),
             torch.full((128,), 5.0))
    z = torch.zeros(128)
    rfT = pt._ray_feature_rows(O, Vec3(z, z, z - 1.0))
    bits = torch.full((1, 128 // SUBG), -1, dtype=torch.int32)  # all on
    return rfT, fields, bits


def _check_tie(t, idx, *n):
    assert torch.equal(t, torch.full_like(t, 5.0))
    assert (idx == 3).all()  # the lowest original id, not the first slot
    if n:
        nx, ny, nz = n
        assert (nz > 0).all() and (nx == 0).all() and (ny == 0).all()


def test_plain_closest_breaks_ties_by_lowest_id():
    rfT, fields, bits = _tie_table()
    for name, _, _ in CLOSEST:
        _check_tie(*getattr(pt, f"{name}_plain")(rfT, fields, bits, EPS,
                                                 SUBG, 128))
    assert torch.equal(pt.pairs_shadow_plain(rfT, fields, bits, EPS, SUBG,
                                             128), torch.full((128,), 5.0))


# ------------------------------------------- tiled traversal (B5, B6), CPU

def _tiled_cast(scene, kind, R, device, seed=0, capped=True, subg=SUBG):
    """A tiled cast of ``R`` rays: (tables, O, u, cap, rfT, lists)."""
    cfg, tables = scene
    O, u = _rays(kind, cfg, tables, R, seed)
    O = Vec3(*(c.to(device) for c in O))
    u = Vec3(*(c.to(device) for c in u))
    tab = tables.pallas_mesh._replace(**{
        f: getattr(tables.pallas_mesh, f).to(device)
        for f in ("fields", "fieldsT", "tile_aabb")})
    spheres = type(tables.spheres)(*(c.to(device) for c in tables.spheres))
    cap = intersect_spheres(O, u, spheres)[0] if capped else None
    rfT, lists, _, _ = pat.cast_inputs(O, u, tab, subg, cap=cap)
    return tab, O, u, cap, rfT, lists


def _all_tiles(lists):
    """Every subgroup lists every tile, ascending."""
    nt = lists.shape[1] - 1
    ids = torch.arange(nt, dtype=torch.int32).expand(lists.shape[0], nt)
    return torch.cat([torch.full((lists.shape[0], 1), nt, dtype=torch.int32),
                      ids], dim=1).contiguous()


def test_tiled_plain_is_exact_against_brute_force(scene):
    """Tile culling is exact: B5 and B6 over the listed tiles find what
    they find over every tile."""
    tab, _, _, _, rfT, lists = _tiled_cast(scene, "camera", 2048, "cpu",
                                           seed=8, capped=False)
    args = lambda ls: (rfT, tab.fields, ls, EPS, SUBG)
    got = pat.pallas_closest_plain(*args(lists))
    want = pat.pallas_closest_plain(*args(_all_tiles(lists)))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[0] < pt.INF32).sum() > 100
    assert (lists[:, 0] < tab.n_tiles).all()  # culling did cull
    assert torch.equal(pat.pallas_shadow_plain(*args(lists)),
                       pat.pallas_shadow_plain(*args(_all_tiles(lists))))


@pytest.mark.parametrize("kind", KINDS)
def test_tiled_closest_equals_pairs_b0_uncapped(scene, kind):
    """B5 and B0 compute the same closest hit from the same field formulas
    (field rows 0-15 are equal per triangle, and the pairs tables carry
    the tiled index as the original id), so uncapped, where both cullings
    are conservative, they agree bit for bit."""
    tab, O, u, _, rfT, lists = _tiled_cast(scene, kind, 4096, "cpu", seed=3,
                                           capped=False)
    b5 = pat.pallas_closest_plain(rfT, tab.fields, lists, EPS, SUBG)
    b0 = pt.intersect_tris_pairs(O, u, scene[1].pairs_mesh, EPS, subg=SUBG,
                                 blk=BLK)
    assert torch.equal(b5[0], b0.t) and torch.equal(b5[1], b0.idx)
    assert (b5[0] < pt.INF32).sum() > 50


def test_tiled_cpu_tensors_run_the_plain_versions(scene):
    tab, O, u, cap, rfT, lists = _tiled_cast(scene, "depth1", 4096, "cpu")
    before = dict(_kernels.LAUNCHES)
    args = (rfT, tab.fields, lists, EPS, SUBG)
    t, idx = pat.pallas_closest(*args)
    want = pat.pallas_closest_plain(*args)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    assert torch.equal(pat.pallas_shadow(*args),
                       pat.pallas_shadow_plain(*args))
    hit = pat.intersect_tris_pallas(O, u, tab, EPS, sort_rays=False, cap=cap,
                                    subg=SUBG)
    assert torch.equal(hit.t, t) and hit.beta is None
    assert _kernels.LAUNCHES == before  # nothing was launched
    miss = t >= pt.INF32
    assert miss.any() and (~miss).any()
    assert (idx[miss] == 0).all()
    assert idx.dtype == torch.int32 and t.dtype == torch.float32
    assert lists.dtype == torch.int32 and lists.shape == (4096 // SUBG, 33)


@pytest.mark.parametrize("bad", ["dtype", "columns", "rays", "rows",
                                 "tiles"])
def test_tiled_wrappers_check_their_inputs(bad):
    """B5 and B6 refuse what they do not take: int32 lists of one row of
    [count, n_tiles ids] per subgroup, 16 field rows of whole tiles."""
    R, Tp = 256, 256
    rfT = torch.zeros(16, R)
    fields = torch.zeros(16, Tp)
    lists = torch.zeros(R // SUBG, 1 + Tp // 128, dtype=torch.int32)
    if bad == "dtype":
        lists = lists.long()
    elif bad == "columns":
        lists = torch.zeros(R // SUBG, 2 + Tp // 128, dtype=torch.int32)
    elif bad == "rays":
        rfT = torch.zeros(16, R + 32)
    elif bad == "rows":
        fields = torch.zeros(15, Tp)
    else:
        fields = torch.zeros(16, Tp + 32)
    for name in ("pallas_closest", "pallas_shadow"):
        with pytest.raises(ValueError):
            getattr(_kernels, name)(rfT, fields, lists, EPS, SUBG)


def test_tiled_lists_read_count_ids_only():
    """A list names the tiles among its first ``count`` ids; later ids
    and ids outside [0, n_tiles) are ignored (the kernels skip them)."""
    lists = torch.tensor([[2, 3, 1, 0, 2],
                          [0, 1, 2, 3, 0],
                          [3, -1, 7, 2, 0],
                          [9, 0, 0, 0, 0]], dtype=torch.int32)
    got = pat._listed_tiles(lists, 4)
    want = torch.tensor([[0, 1, 0, 1], [0, 0, 0, 0], [0, 0, 1, 0],
                         [1, 0, 0, 0]], dtype=torch.bool)
    assert torch.equal(got, want)


def _tiled_tie_table():
    """Triangles 5 and 200 (tiles 0 and 1) are the same triangle at z = 0;
    the rest lie far away.  128 rays straight down hit both at t = 5."""
    T = 256
    A = np.full((T, 3), 50.0, np.float32)
    B, C = A + np.float32([1, 0, 0]), A + np.float32([0, 1, 0])
    for i in (5, 200):
        A[i], B[i], C[i] = (-10, -10, 0), (10, -10, 0), (-10, 10, 0)
    tab = pat.build_pallas_tables(A, B, C, "cpu")
    xy = np.random.default_rng(0).uniform(-8, 0, (2, 128)).astype(np.float32)
    O = Vec3(torch.from_numpy(xy[0]), torch.from_numpy(xy[1]),
             torch.full((128,), 5.0))
    z = torch.zeros(128)
    return tab, O, Vec3(z, z, z - 1.0)


def test_tiled_plain_breaks_ties_by_lowest_index():
    """The lowest index wins an exact-t tie whatever the order of the
    list (the JAX kernel walks ascending tiles; B5 compares (t, index))."""
    tab, O, u = _tiled_tie_table()
    rfT = pat._ray_features16(O, u)
    for order in ([0, 1], [1, 0]):
        lists = torch.tensor([[2] + order] * 2, dtype=torch.int32)
        t, idx = pat.pallas_closest_plain(rfT, tab.fields, lists, EPS, SUBG)
        assert torch.equal(t, torch.full((128,), 5.0)) and (idx == 5).all()
    hit = pat.intersect_tris_pallas(O, u, tab, EPS)
    assert (hit.idx == 5).all()
    assert torch.equal(pat.intersect_tris_shadow(O, u, tab, EPS),
                       torch.full((128,), 5.0))


@pytest.mark.parametrize("subg", [16, 32, 64])
def test_tiled_casts_keep_their_lists_under_the_32_bit_limit(subg):
    """A mesh past the pairs tables' ceiling renders through the tiled
    kernels with some 400,000 tiles: chunk_size cuts its pallas casts to
    whole BLK_R blocks whose lists, (rays / subgroup, 1 + n_tiles) int32,
    the launch check takes, where a full 524,288-ray cast's lists pass
    2^31 elements and are refused.  Shapes only (meta tensors: nothing is
    allocated); a table of the cat's size keeps full casts."""
    import dataclasses

    from raytracinggpu_tpu_torch.render.pipeline import chunk_size
    from raytracinggpu_tpu_torch.scene.scene import RenderConfig

    cfg = dataclasses.replace(RenderConfig(), pallas_subgroup=subg)
    n_tiles, R = 400_000, 4 * 512 * 512
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")

    def check(rays):
        return _kernels._check(
            meta(16, rays), meta(16, n_tiles * 128),
            meta(rays // subg, 1 + n_tiles, dt=torch.int32), subg, 128, 16,
            "lists")

    chunk = chunk_size(cfg, R, "pallas", n_tiles=n_tiles)
    assert chunk % pat.BLK_R == 0 and 0 < chunk < cfg.pairs_chunk
    assert (chunk // subg) * (1 + n_tiles) < 2**31
    assert check(chunk) == (chunk, n_tiles * 128, 1 + n_tiles)
    with pytest.raises(ValueError, match="32-bit"):
        check(cfg.pairs_chunk)
    assert chunk_size(cfg, R, "pallas", n_tiles=32) == cfg.pairs_chunk
    assert chunk_size(cfg, R, "pairs") == cfg.pairs_chunk


@pytest.mark.parametrize("subg", [0, 48, 256])
def test_tiled_subgroup_must_divide_the_tile(scene, subg):
    tab = scene[1].pallas_mesh
    O = Vec3(*(torch.zeros(256) for _ in range(3)))
    u = Vec3(torch.zeros(256), torch.zeros(256), torch.ones(256))
    with pytest.raises(ValueError, match="pallas_subgroup"):
        pat.intersect_tris_pallas(O, u, tab, EPS, subg=subg)


# ------------- B6's mapping: the properties its warp walk relies on, held
# on the plain version at every legal subgroup, on the cat (a fan from the
# camera, capped by the spheres or not) and on a random mesh (rays from
# points in its box, random caps)

TILED_SUBGS = (8, 16, 32, 64, 128)
TILED_MESHES = ("cat", "random")


@pytest.fixture(scope="module")
def tiled_rays(scene):
    """{(mesh, capped): (table, O, u, cap)} of 1024 rays on the CPU."""
    cfg, tables = scene
    rng = np.random.default_rng(11)
    A = rng.uniform(-20, 20, (1100, 3)).astype(np.float32)
    A = A[np.argsort(A[:, 0])]  # tiles are slabs across x
    B = A + rng.standard_normal((1100, 3)).astype(np.float32) * 2
    C = A + rng.standard_normal((1100, 3)).astype(np.float32) * 2
    rand = pat.build_pallas_tables(A, B, C, "cpu")  # 9 tiles, 52 padding
    o = rng.uniform(-20, 20, (3, 1024)).astype(np.float32)
    o = o[:, np.argsort(o[0])]  # a subgroup's rays start close together
    d = rng.standard_normal((3, 1024)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rand_rays = (Vec3(*map(torch.from_numpy, o)),
                 Vec3(*map(torch.from_numpy, d)),
                 torch.from_numpy(rng.uniform(1, 6, 1024).astype(np.float32)))
    O, u = _rays("camera", cfg, tables, 1024, seed=5)
    cat_cap = intersect_spheres(O, u, tables.spheres)[0]
    out = {}
    for capped in (False, True):
        out["cat", capped] = (tables.pallas_mesh, O, u,
                              cat_cap if capped else None)
        out["random", capped] = (rand, *rand_rays[:2],
                                 rand_rays[2] if capped else None)
    return out


def _subg_cast(tiled_rays, mesh, capped, subg):
    """(table, rfT, lists) of one tiled cast at ``subg``."""
    tab, O, u, cap = tiled_rays[mesh, capped]
    rfT, lists, _, _ = pat.cast_inputs(O, u, tab, subg, cap=cap)
    return tab, rfT, lists


def _scrambled(lists, n_tiles, seed=0):
    """Each row's listed ids in another order, and in rows with inactive
    ids to spare, two ids outside [0, n_tiles) slipped among them (count
    raised to match): the same list of tiles."""
    rng = np.random.default_rng(seed)
    out = lists.numpy().copy()
    for row in out:
        c = min(int(row[0]), len(row) - 1)
        ids = list(row[1:1 + c])
        rest = list(row[1 + c:])
        if len(rest) >= 2:
            ids += [-1 - int(rng.integers(5)), n_tiles + int(rng.integers(5))]
            rest = rest[:-2]
        row[0] = len(ids)
        row[1:] = list(rng.permutation(ids)) + list(rng.permutation(rest))
    return torch.from_numpy(out)


def _warp_walk(rfT, fields, lists, eps, subg, foreign_eps=math.inf):
    """A plain model of the mapping of B5 and B6 (csrc/pallas_trace.cu):
    each warp of 32 rays walks the merge of its lanes' lists (every step
    takes the least head id among them, ids outside the table skipped, and
    advances the lists whose head it was); every lane tests the step's
    tile, a lane whose own list's head it was not with ``foreign_eps``
    (+inf in the kernels), and the tile's slots whose Ng is zero are
    skipped.  A lane keeps B5's running min of (t, index) under the
    lexicographic order, the index a slot's position in the table (B6's
    t is its first half).  Returns (t, idx, the tests run with
    ``foreign_eps``)."""
    R, n_tiles, L = rfT.shape[1], fields.shape[1] // 128, lists.shape[1]
    t = torch.full((R,), pt.INF32)
    idx = torch.full((R,), 2**30, dtype=torch.int32)
    foreign = 0
    for w0 in range(0, R, 32):
        lanes = torch.arange(w0, min(w0 + 32, R))
        ids = {}
        for sg in sorted({int(r) // subg for r in lanes}):
            c = max(0, min(int(lists[sg, 0]), L - 1))
            ids[sg] = [i for i in lists[sg, 1:1 + c].tolist()
                       if 0 <= i < n_tiles]
        pos = dict.fromkeys(ids, 0)
        while True:
            heads = {sg: ids[sg][p] for sg, p in pos.items()
                     if p < len(ids[sg])}
            if not heads:
                break
            tile = min(heads.values())
            cols = fields[:, tile * 128:(tile + 1) * 128]
            kept = (cols[:3] != 0).any(dim=0)
            slot = (torch.arange(128, dtype=torch.int32) + tile * 128)[kept]
            own = torch.tensor([heads.get(int(r) // subg) == tile
                                for r in lanes])
            for e, on in ((eps, own), (foreign_eps, ~own)):
                tv, _, _, ok = pat.mt_slots(rfT, cols[:, kept], e, w0,
                                            w0 + len(lanes))
                tv = torch.where(ok, tv, pt.INF32)
                # the tile's own lexicographic min: the first slot at its
                # least t (slots ascend by index)
                tmin, first = tv.min(dim=1) if tv.shape[1] else (
                    torch.full((len(lanes),), pt.INF32),
                    torch.zeros(len(lanes), dtype=torch.long))
                imin = slot[first] if len(slot) else first.int()
                old_t, old_i = t[lanes], idx[lanes]
                take = on & ok.any(dim=1) & (
                    (tmin < old_t) | ((tmin == old_t) & (imin < old_i)))
                t[lanes] = torch.where(take, tmin, old_t)
                idx[lanes] = torch.where(take, imin, old_i)
            foreign += int((~own).sum()) * int(kept.sum())
            for sg, h in heads.items():
                pos[sg] += h == tile
    return t, torch.where(t < pt.INF32, idx, 0), foreign


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", TILED_SUBGS)
@pytest.mark.parametrize("mesh", TILED_MESHES)
def test_tiled_shadow_plain_ignores_the_order_of_each_list(tiled_rays, mesh,
                                                           subg, capped):
    """B6's result is a min of f32 values over the listed tiles: the ids of
    a list in another order, with ids outside the table among them, give
    the same t bit for bit."""
    tab, rfT, lists = _subg_cast(tiled_rays, mesh, capped, subg)
    other = _scrambled(lists, tab.n_tiles, seed=subg)
    assert not torch.equal(other, lists)
    want = pat.pallas_shadow_plain(rfT, tab.fields, lists, EPS, subg)
    assert torch.equal(
        pat.pallas_shadow_plain(rfT, tab.fields, other, EPS, subg), want)
    assert (want < pt.INF32).sum() > 100


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", TILED_SUBGS)
@pytest.mark.parametrize("mesh", TILED_MESHES)
def test_tiled_shadow_plain_equals_a_warp_walk_over_the_union(tiled_rays,
                                                              mesh, subg,
                                                              capped):
    """B6's warp walk (_warp_walk), on the scrambled lists, gives
    the plain version's t bit for bit: a ray tests the union of its warp's
    lists, the tiles its own list lacked with eps = +inf (below 32 rays a
    subgroup a warp spans several lists, and without the +inf a ray would
    see tiles its subgroup culled), and padding slots are skipped."""
    tab, rfT, lists = _subg_cast(tiled_rays, mesh, capped, subg)
    want = pat.pallas_shadow_plain(rfT, tab.fields, lists, EPS, subg)
    got, _, foreign = _warp_walk(
        rfT, tab.fields, _scrambled(lists, tab.n_tiles, seed=subg), EPS,
        subg)
    assert torch.equal(got, want)
    assert (foreign > 0) == (subg < 32)
    if mesh == "random" and capped and subg < 32:
        # the trap the +inf avoids: with the ray's eps on tiles only a
        # neighbouring subgroup kept, rays find hits beyond their caps
        wrong, _, _ = _warp_walk(rfT, tab.fields, lists, EPS, subg,
                                 foreign_eps=EPS)
        assert int((wrong < want).sum()) >= 5


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", TILED_SUBGS)
@pytest.mark.parametrize("mesh", TILED_MESHES)
def test_tiled_shadow_plain_ignores_padding_slots(tiled_rays, mesh, subg,
                                                  capped):
    """A slot whose Ng is zero (padding) never changes B6's t, whatever
    its other rows hold, on the culled lists and on lists of every tile
    (the padding-only tile too), so B6 may skip it."""
    tab, rfT, lists = _subg_cast(tiled_rays, mesh, capped, subg)
    pad = (tab.fields[:3] == 0).all(dim=0)
    assert int(pad.sum()) == {"cat": 142, "random": 52}[mesh]
    g = torch.Generator().manual_seed(subg)
    junk = tab.fields.clone()
    junk[3:, pad] = torch.randn(13, int(pad.sum()), generator=g) * 50.0
    for ls in (lists, _all_tiles(lists)):
        assert torch.equal(
            pat.pallas_shadow_plain(rfT, junk, ls, EPS, subg),
            pat.pallas_shadow_plain(rfT, tab.fields, ls, EPS, subg))


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", TILED_SUBGS)
@pytest.mark.parametrize("mesh", TILED_MESHES)
def test_tiled_closest_plain_equals_a_warp_walk_over_the_union(tiled_rays,
                                                               mesh, subg,
                                                               capped):
    """B5's warp walk (_warp_walk), on the scrambled lists, gives the plain
    version's (t, idx) bit for bit: the lexicographic min of (t, index)
    does not depend on the order of the tiles, the lanes whose own list
    lacked a tile (below 32 rays a subgroup) test it with eps = +inf, and
    padding slots are skipped."""
    tab, rfT, lists = _subg_cast(tiled_rays, mesh, capped, subg)
    want = pat.pallas_closest_plain(rfT, tab.fields, lists, EPS, subg)
    t, idx, foreign = _warp_walk(
        rfT, tab.fields, _scrambled(lists, tab.n_tiles, seed=subg), EPS,
        subg)
    assert torch.equal(t, want[0]) and torch.equal(idx, want[1])
    assert (foreign > 0) == (subg < 32)
    assert (want[0] < pt.INF32).sum() > 100


# slots of one big triangle at z = 0 in the tie mesh: two in the first
# 32-slot piece of tile 0, one in tile 3, one in tile 6
TIE_SLOTS = (5, 20, 3 * 128 + 70, 6 * 128 + 100)


def _tie_mesh(R, seed=0):
    """(table, rfT): 1,100 small random triangles (9 tiles, the last part
    padding) with the slots TIE_SLOTS holding one big triangle at z = 0;
    R rays, the even ones straight down onto it from z = 25 (every copy
    is hit at the same t, bit for bit), the odd ones random."""
    rng = np.random.default_rng(seed)
    A = rng.uniform(-20, 20, (1100, 3)).astype(np.float32)
    B = A + rng.standard_normal((1100, 3)).astype(np.float32) * 2
    C = A + rng.standard_normal((1100, 3)).astype(np.float32) * 2
    for i in TIE_SLOTS:
        A[i], B[i], C[i] = (-30, -30, 0), (30, -30, 0), (-30, 30, 0)
    tab = pat.build_pallas_tables(A, B, C, "cpu")
    o = rng.uniform(-20, 20, (3, R)).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    o[:2, 0::2] = rng.uniform(-25, 0, (2, (R + 1) // 2))
    o[2, 0::2] = 25.0
    d[:, 0::2] = np.float32([[0.0], [0.0], [-1.0]])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = Vec3(*map(torch.from_numpy, o))
    u = Vec3(*map(torch.from_numpy, d))
    return tab, pat._ray_features16(O, u)


def _odd_lists(n_tiles, S, seed=0):
    """(S, 1 + n_tiles) int32 list rows of every shape the kernels must
    take: a random subset of the tiles in random order, or descending, or
    with ids outside the table among them, or with one id listed twice,
    or a count past the row's width (every entry is then read, the
    entries after the subset random ids inside and outside the table)."""
    rng = np.random.default_rng(seed)
    out = rng.integers(-3, n_tiles + 3, (S, 1 + n_tiles)).astype(np.int32)
    for row in out:
        ids = [int(i) for i in rng.permutation(n_tiles)[
            :rng.integers(0, n_tiles + 1)]]
        mode = int(rng.integers(5))
        if mode == 0:
            ids.sort(reverse=True)
        elif mode == 1:
            ids = (ids + [-2, n_tiles + 5])[:n_tiles]
        elif mode == 2 and ids:
            ids = (ids + ids[:1])[:n_tiles]
        row[1:1 + len(ids)] = ids
        row[0] = 999 if mode == 3 else len(ids)
    return torch.from_numpy(out)


@pytest.mark.parametrize("subg", [8, 16])
def test_tiled_closest_plain_equals_a_warp_walk_on_ties_and_odd_lists(subg):
    """The walk of B5 and B6 below one warp a subgroup, where a warp's lanes
    walk lists that differ in every way _odd_lists makes them, equals the
    plain versions bit for bit: exact-t ties between tiles and inside one
    32-slot piece go to the lowest index listed, whatever the order."""
    tab, rfT = _tie_mesh(1024, seed=subg)
    lists = _odd_lists(tab.n_tiles, 1024 // subg, seed=subg)
    t, idx = pat.pallas_closest_plain(rfT, tab.fields, lists, EPS, subg)
    got_t, got_i, foreign = _warp_walk(rfT, tab.fields, lists, EPS, subg)
    assert torch.equal(got_t, t) and torch.equal(got_i, idx)
    assert torch.equal(got_t, pat.pallas_shadow_plain(rfT, tab.fields, lists,
                                                      EPS, subg))
    assert foreign > 0
    # ties decided: rays whose lists name tile 0 win the first copy of
    # the triangle, the rest the lowest copy they list
    won = {i: int((idx == i).sum()) for i in TIE_SLOTS}
    assert won[5] > 20 and won[3 * 128 + 70] + won[6 * 128 + 100] > 5
    assert won[20] == 0


# ------------------------------------- tables past 32,768 slots (B4 sizes)

def _big_table(n_tiles=301, R=4096, subg=SUBG, seed=0):
    """A synthetic pairs cast at the sizes where the JAX package streams
    its field table in 32,768-slot supertiles (B4): ``n_tiles`` tiles of
    128 slots, the last one part padding, holding small random triangles
    under scrambled original ids, with unit vertex normals (for B3); R
    random rays; a random bitmask whose last word (tiles 288-319) has
    every bit set, naming tiles past the table.  Returns (rfT, fields,
    bits) on the CPU."""
    rng = np.random.default_rng(seed)
    T = n_tiles * 128 - 50
    A = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    B = A + rng.standard_normal((T, 3)).astype(np.float32) * 0.5
    C = A + rng.standard_normal((T, 3)).astype(np.float32) * 0.5
    n = rng.standard_normal((3, T, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=2, keepdims=True)
    slot_src = np.full(n_tiles * 128, -1, np.int32)
    slot_src[:T] = rng.permutation(T).astype(np.int32)
    fields = torch.from_numpy(pt.fields_from_corners(A, B, C, slot_src, *n))
    o = rng.uniform(-25, 25, (3, R)).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rfT = pt._ray_feature_rows(Vec3(*map(torch.from_numpy, o)),
                               Vec3(*map(torch.from_numpy, d)))
    W = -(-n_tiles // 32)
    words = rng.integers(0, 2**32, (W, R // subg), dtype=np.uint64)
    bits = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    bits[-1] = -1
    return rfT, fields, bits


@pytest.mark.parametrize("subg", [16, 64])
def test_plain_versions_ignore_bits_past_the_table(subg):
    """On a table past 32,768 slots, bits naming tiles past the table
    change nothing: the last word with those bits cleared gives the same
    results."""
    rfT, fields, bits = _big_table(R=512, subg=subg)
    n_tiles = fields.shape[1] // 128
    assert fields.shape[1] > 32768 and n_tiles >= 300
    assert bits.shape[0] * 32 > n_tiles
    clean = bits.clone()
    clean[-1] = (1 << (n_tiles - 32 * (bits.shape[0] - 1))) - 1
    for name in ("pairs_closest", "pairs_closest_smooth",
                 "pairs_closest_idx", "pairs_shadow"):
        plain = getattr(pt, f"{name}_plain")
        got = plain(rfT, fields, bits, EPS, subg, 128)
        want = plain(rfT, fields, clean, EPS, subg, 128)
        got, want = ((got,), (want,)) if name == "pairs_shadow" else (got,
                                                                     want)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
        assert (got[0] < pt.INF32).sum() > 20


# ------------------- any mapping of slots to threads: the property B0-B3 use

PAIRS_KERNELS = ("pairs_closest", "pairs_closest_smooth", "pairs_closest_idx",
                 "pairs_shadow")


def _unpack(bits, n_tiles):
    """(n_tiles, S) bool: tile j active for subgroup sg."""
    w = bits.to(torch.int64) & 0xFFFFFFFF
    sh = torch.arange(32, dtype=torch.int64)
    on = ((w[:, None, :] >> sh[None, :, None]) & 1).bool()
    return on.reshape(-1, w.shape[1])[:n_tiles]


def _pack(on):
    """The (W, S) int32 bitmask of an (n_tiles, S) bool (as _pair_bits)."""
    n_tiles, S = on.shape
    W = -(-n_tiles // 32)
    act = torch.zeros(W * 32, S, dtype=torch.int64)
    act[:n_tiles] = on.to(torch.int64)
    sh = torch.arange(32, dtype=torch.int64)
    words = (act.reshape(W, 32, S) << sh[None, :, None]).sum(dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _plane_slots(n_tiles, tile_t):
    """The slots of _synthetic_cast's plane: its two triangles in tile 1,
    then again in tile n_tiles - 2."""
    return (tile_t + 3, tile_t + 9, (n_tiles - 2) * tile_t + 5,
            (n_tiles - 2) * tile_t + 1)


def _synthetic_cast(n_tiles=37, tile_t=128, R=512, subg=16, seed=0):
    """A pairs cast on a synthetic table: ``n_tiles`` tiles of ``tile_t``
    slots holding random triangles of a few units in a 40-unit box under
    scrambled original ids, with unit vertex normals (for B3), the last
    tile part padding; two large triangles covering the plane z = 0
    stored twice, in tiles 1 and n_tiles - 2 under other ids, so that a
    ray crossing the plane finds exact-t ties between slots of different
    tiles; R rays from random points in the box; a random bitmask whose
    last word also sets bits naming tiles past the table.  Returns (rfT,
    fields, bits) on the CPU."""
    rng = np.random.default_rng(seed)
    Tc = n_tiles * tile_t
    T = Tc - tile_t // 2
    A = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    B = A + rng.standard_normal((T, 3)).astype(np.float32)
    C = A + rng.standard_normal((T, 3)).astype(np.float32)
    n = rng.standard_normal((3, T, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=2, keepdims=True)
    slot_src = np.full(Tc, -1, np.int32)
    slot_src[:T] = rng.permutation(T).astype(np.int32)
    quad = np.float32([[[-30, -30, 0], [30, -30, 0], [-30, 30, 0]],
                       [[30, 30, 0], [-30, 30, 0], [30, -30, 0]]])
    for i, slot in enumerate(_plane_slots(n_tiles, tile_t)):
        tid = slot_src[slot]
        A[tid], B[tid], C[tid] = quad[i % 2]
    fields = torch.from_numpy(pt.fields_from_corners(A, B, C, slot_src, *n))
    o = rng.uniform(-20, 20, (3, R)).astype(np.float32)
    d = rng.standard_normal((3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rfT = pt._ray_feature_rows(Vec3(*map(torch.from_numpy, o)),
                               Vec3(*map(torch.from_numpy, d)))
    W = -(-n_tiles // 32)
    words = rng.integers(0, 2**32, (W, R // subg), dtype=np.uint64)
    for j in (1, n_tiles - 2):  # both copies of the plane kept everywhere
        words[j // 32] |= np.uint64(1 << (j % 32))
    if n_tiles % 32:  # bits past the table
        words[-1] |= np.uint64(2**32 - 2**(n_tiles % 32))
    bits = torch.from_numpy(words.astype(np.uint32).view(np.int32))
    return rfT, fields, bits


def _outputs(name, args):
    out = getattr(pt, f"{name}_plain")(*args)
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("what", ["slots", "tiles"])
@pytest.mark.parametrize("name", PAIRS_KERNELS)
def test_plain_versions_do_not_depend_on_slot_or_tile_order(name, what):
    """B0-B3 are a min under a total order, (t, id) or t, and the payload
    is the winner's own: permuting the slots inside every tile, or whole
    tiles with the bitmask remapped to match, changes no output bit.  The
    kernels' thread mapping rests on this.  The cast holds exact-t ties
    between slots of different tiles, won by the lower id."""
    tile_t, subg = 128, 16
    rfT, fields, bits = _synthetic_cast(tile_t=tile_t, subg=subg)
    n_tiles = fields.shape[1] // tile_t
    args = (rfT, fields, bits, EPS, subg, tile_t)
    want = _outputs(name, args)
    rng = np.random.default_rng(1)
    if what == "slots":
        perm = np.concatenate([j * tile_t + rng.permutation(tile_t)
                               for j in range(n_tiles)])
        moved = (rfT, fields[:, torch.from_numpy(perm)].contiguous(), bits)
    else:
        perm = torch.from_numpy(rng.permutation(n_tiles))
        f = fields.reshape(32, n_tiles, tile_t)[:, perm].reshape(32, -1)
        moved = (rfT, f.contiguous(), _pack(_unpack(bits, n_tiles)[perm]))
        assert not torch.equal(moved[2], bits)
    got = _outputs(name, moved + args[3:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    t = want[0]
    assert (t < pt.INF32).sum() > 100
    if name != "pairs_shadow":
        # the plane's ties: both copies at the same t, the lower id wins
        plane = fields[16, list(_plane_slots(n_tiles, tile_t))].to(
            torch.int32)
        won = torch.isin(want[1], plane) & (t < pt.INF32)
        assert won.sum() > 20
        low = torch.minimum(plane[[0, 1]], plane[[2, 3]])
        assert torch.isin(want[1][won], low).all()


@pytest.mark.parametrize("tile_t", [48, 80])
@pytest.mark.parametrize("name", PAIRS_KERNELS)
def test_pairs_wrappers_need_tiles_of_a_multiple_of_32(name, tile_t):
    """The pairs kernels stage a tile in pieces of 32 slots, so
    their wrappers refuse any other tile width (build_pairs_tables builds
    only multiples of 32); the plain versions take any."""
    rfT, fields, bits = _synthetic_cast(n_tiles=4, tile_t=tile_t, R=64)
    with pytest.raises(ValueError, match="multiple of 32"):
        getattr(_kernels, name)(rfT, fields, bits, EPS, 16, tile_t)
    assert _outputs(name, (rfT, fields, bits, EPS, 16, tile_t))[0].shape \
        == (64,)


@pytest.mark.parametrize("subg", [16, 64])
def test_pairs_design_counts_the_tests_of_a_cast(subg):
    """bench/pairs_design.mt_tests: a ray tests every slot of every tile its
    subgroup keeps, so a cast's tests are its set bits x tile_t x subg;
    the top bit of a word (a negative int32) counts too."""
    from raytracinggpu_tpu_torch.bench import pairs_design

    _, _, bits = _synthetic_cast(n_tiles=40, R=512, subg=subg)
    n_set = int(_unpack(bits, 64).sum())
    assert (bits < 0).any() and n_set > 0
    assert pairs_design.mt_tests(bits, subg, 128) == n_set * 128 * subg


def test_pairs_design_reads_the_pairs_kernels_registers():
    """bench/pairs_design.registers reads each pairs mode's registers from a
    ptxas -v report and skips the other kernels' entries."""
    from raytracinggpu_tpu_torch.bench import pairs_design

    def entry(mangled, regs):
        return (f"ptxas info    : Compiling entry function '{mangled}' for "
                "'sm_90a'\n"
                f"ptxas info    : Function properties for {mangled}\n"
                "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
                "spill loads\n"
                f"ptxas info    : Used {regs} registers, used 0 barriers, "
                "10240 bytes smem\n")

    report = (entry("_ZN12_GLOBAL__N_112pairs_kernelILi2EEEvPKfS2_PKiiiiiif",
                    48)
              + entry("_ZN12_GLOBAL__N_113pallas_kernelILb1EEEvPKf", 64)
              + entry("_ZN12_GLOBAL__N_112pairs_kernelILi0EEEvPKfS2_PKi", 40))
    assert pairs_design.registers(report) == {"ILi2E": 48, "ILi0E": 40}


@pytest.mark.parametrize("subg", [16, 64])
def test_tiled_design_counts_the_tests_of_a_cast(tiled_rays, subg):
    """bench/tiled_design.mt_tests: a ray tests the 128 slots of each tile
    its subgroup's list names, so a cast's tests are its listed tiles x
    128 x subg."""
    from raytracinggpu_tpu_torch.bench import tiled_design

    tab, _, lists = _subg_cast(tiled_rays, "cat", True, subg)
    n_listed = int(pat._listed_tiles(lists, tab.n_tiles).sum())
    assert 0 < n_listed < lists.shape[0] * tab.n_tiles
    assert tiled_design.mt_tests(lists, subg) == n_listed * 128 * subg


def _ptxas_entry(mangled, regs, smem):
    return (f"ptxas info    : Compiling entry function '{mangled}' for "
            "'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            "    0 bytes stack frame, 0 bytes spill stores, 0 bytes "
            "spill loads\n"
            f"ptxas info    : Used {regs} registers, used 1 barriers, "
            f"{smem} bytes smem, 400 bytes cmem[0]\n")


def test_design_benches_read_each_kernels_resources():
    """bench/pairs_design.kernel_resources names each kernel of a ptxas -v
    report by its identifier and mangled template arguments, with its
    registers and shared memory (what bench/tiled_design prints)."""
    from raytracinggpu_tpu_torch.bench import pairs_design

    report = (_ptxas_entry("_ZN12_GLOBAL__N_112pairs_kernelILi2EEEvPKfS2_PKi"
                           "iiiiifPfPiS3_S3_S3_", 48, 20480)
              + _ptxas_entry("_ZN12_GLOBAL__N_112tiled_kernelILb0EEEvPKfS2_PKi"
                             "iiiifPfPi", 40, 20480)
              + _ptxas_entry("_ZN12_GLOBAL__N_117block_mask_kernelILb1EEEvPKf"
                             "Pf", 16, 2048)
              + _ptxas_entry("_ZN46_INTERNAL_5c3a6b2e_15_pallas_trace_cu_d1f"
                             "0a9b312tiled_kernelILb1EEEvPKfS2_PKiiiiifPfPi",
                             48, 20480)
              + _ptxas_entry("_ZN12_GLOBAL__N_117pair_slope_kernelILi4EEEvPKi"
                             "PKfS4_iiiPf", 56, 167936))
    assert pairs_design.kernel_resources(report) == {
        "pairs_kernelILi2E": (48, 20480), "tiled_kernelILb0E": (40, 20480),
        "block_mask_kernelILb1E": (16, 2048),
        "tiled_kernelILb1E": (48, 20480),
        "pair_slope_kernelILi4E": (56, 167936)}
    assert pairs_design.registers(report) == {"ILi2E": 48}


# ------------------------------------------- the probes (B7a-e), CPU

@pytest.mark.parametrize("bad,why", [
    ("dtype", "int32"), ("device", "CUDA"), ("rows", "one row per"),
    ("tiles", "whole 128-triangle tiles"), ("columns", "128 columns"),
    ("subgroup", "does not divide"), ("blocks", "whole blocks")])
def test_probe_wrappers_check_their_inputs(bad, why):
    """The probe wrappers take CUDA tensors only (a CPU tensor goes to the
    plain version in bench/micro_kernel.py) and refuse what their kernels
    do not take, each for its own reason, before anything is built or
    launched (shapes first, so tensors without storage can show it)."""
    R = 2048
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    rf, tri = meta(R, 16), meta(16, 5 * 128)
    lists = meta(R // 64, 128, dt=torch.int32)
    pairs = meta(R // 1024, 9, dt=torch.int32)
    idx = meta(R, 1, dt=torch.int32)
    before = dict(_kernels.LAUNCHES)
    calls = {
        "dtype": lambda: _kernels.probe_tile_slope(lists.long(), rf, tri),
        "device": lambda: _kernels.probe_block_mask(torch.zeros(1024, 16)),
        "rows": lambda: _kernels.probe_tile_slope(lists[:-1], rf, tri),
        "tiles": lambda: _kernels.probe_uniform_branch(
            lists, rf, meta(16, 5 * 128 + 64)),
        "columns": lambda: _kernels.probe_row_gather(idx, meta(64, 64)),
        "subgroup": lambda: _kernels.probe_pair_slope(pairs, rf, tri, 48),
        "blocks": lambda: _kernels.probe_block_mask(meta(1000, 16)),
    }
    with pytest.raises(ValueError, match=why):
        calls[bad]()
    assert _kernels.LAUNCHES == before


def _shuffled_pairs(pairs, n_tiles, subg, seed=0):
    """B7e's pair rows made harder: each block's pairs in random order (one
    subgroup's pairs spread through the list), one pair listed twice, and
    three that name no subgroup or tile of the block or the table; block 1
    gives a count past its row's width (every entry is then read)."""
    rng = np.random.default_rng(seed)
    n_sg = 1024 // subg
    rows = []
    for row in pairs.numpy():
        ids = list(rng.permutation(row[1:1 + row[0]]))
        if ids:
            ids.insert(int(rng.integers(len(ids) + 1)), ids[0])
        for bad in (-5, n_sg * 256 + 1, (n_sg - 1) * 256 + n_tiles):
            ids.insert(int(rng.integers(len(ids) + 1)), bad)
        rows.append([len(ids)] + ids)
    out = np.zeros((len(rows), max(map(len, rows))), np.int32)
    for r, row in zip(out, rows):
        r[:len(row)] = row
    if len(out) > 1:
        out[1, 0] = 10**6
    return torch.from_numpy(out)


def _pair_slope_model(pairs, rf, tri, subg):
    """A plain model of B7e's mapping (csrc/micro_kernel.cu): the list's
    pairs cut into warp items of min(subg, 32) rays; in an item lane l is
    ray l % kSub (kSub = min(subg, 32)) and takes the slots l // kSub,
    + kM, ... (kM = 32 / kSub) of each 32-slot piece, padding slots (Ng
    = 0) skipped; the lanes of one ray combine their mins in the kernel's
    __shfl_xor_sync tree, and each ray's min joins the block's running
    min as an integer min of the f32 bit patterns (the atomicMin)."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    R, n_tiles = rf.shape[0], tri.shape[1] // 128
    n_sg, parts = 1024 // subg, max(1, subg // 32)
    k_sub = min(subg, 32)
    k_m = 32 // k_sub
    lane = torch.arange(32)
    t_run = torch.full((R,), mk.MISS).view(torch.int32)
    for b in range(R // 1024):
        row = pairs[b].tolist()
        count = min(row[0], len(row) - 1)
        for it in range(max(count, 0) * parts):
            p = row[1 + it // parts]
            sg, tile = p >> 8, p & 255
            if p < 0 or sg >= n_sg or tile >= n_tiles:
                continue
            first = b * 1024 + sg * subg + (it % parts) * 32
            cols = tri[:, tile * 128:(tile + 1) * 128]
            t = mk._mt(rf[first:first + k_sub], cols)
            t[:, (cols[:3] == 0).all(dim=0)] = mk.MISS
            # (ray, piece, i, share) -> lane share * k_sub + ray
            v = t.view(k_sub, 4, 32 // k_m, k_m).amin(dim=(1, 2))
            v = v.T.reshape(32)
            o = k_sub
            while o < 32:
                v = torch.minimum(v, v[lane ^ o])
                o <<= 1
            best = v[:k_sub].view(torch.int32)
            cur = t_run[first:first + k_sub]
            t_run[first:first + k_sub] = torch.where(
                v[:k_sub] < mk.MISS, torch.minimum(cur, best), cur)
    return t_run.view(torch.float32).reshape(R // 128, 128)


@pytest.mark.parametrize("L", [0, 1, 2, 4])
@pytest.mark.parametrize("subg", [4, 8, 16, 32, 64])
def test_pair_slope_plain_equals_the_split_slot_model(subg, L):
    """B7e's mapping (_pair_slope_model) on shuffled pair lists gives the
    plain version's t bit for bit: a min of f32 values does not depend on
    how the slots of a pair are shared among lanes nor on the order of
    the pairs, and every t is positive, so the integer min of the bit
    patterns is the float min."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    rf, tri = mk.cast_inputs(2048, 9, subg, "cpu")
    pairs = _shuffled_pairs(mk.pair_lists(2048, 9, subg, L, "cpu"), 9, subg,
                            seed=L)
    want = mk.pair_slope_plain(pairs, rf, tri, subg)
    assert torch.equal(_pair_slope_model(pairs, rf, tri, subg), want)
    assert bool((want < mk.MISS).any()) == (L > 0)


def _padded_table(tri):
    """A copy of a probe table with padding slots (Ng = 0): every 7th
    column, and the whole second piece of 32 slots of tile 2."""
    tri = tri.clone()
    tri[:3, ::7] = 0.0
    tri[:3, 2 * 128 + 32:2 * 128 + 64] = 0.0
    return tri


def _odd_tile_lists(lists, n_tiles, seed=0):
    """B7a's list rows made harder: each row's ids in random order, with
    ids -1, n_tiles and 200 (no such tile: skipped) among them; row 1
    gives a count past its row's width (cut at Lw - 1, so every entry is
    read, the zeros of its tail as tile 0)."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(lists.numpy())
    for r, row in zip(out, lists.numpy()):
        ids = list(rng.permutation(row[1:1 + row[0]]))
        for bad in (-1, n_tiles, 200):
            ids.insert(int(rng.integers(len(ids) + 1)), bad)
        r[:1 + len(ids)] = [len(ids)] + ids
    out[1, 0] = 10**6
    return torch.from_numpy(out)


def _signed_mask(S, frac, seed=0):
    """B7c's mask, (S, 128) i32: a word is visited iff > 0; a quarter
    true is a fraction 0.25 of positive words, the others 0 or negative."""
    rng = np.random.default_rng(seed)
    on = rng.random((S, 128)) < frac
    m = np.where(on, rng.integers(1, 5, (S, 128)),
                 rng.integers(-5, 1, (S, 128)))
    return torch.from_numpy(m.astype(np.int32))


def _visit_model(rows, rf, tri, masked):
    """A plain model of B7a's and B7c's mapping (csrc/micro_kernel.cu
    visit_kernel<kMasked>): each warp of 32 rays walks its 64-ray
    subgroup's tiles in order (B7a: the listed ids up to min(count, Lw -
    1), ids outside the table skipped; B7c: the fixed tiles j < 8 whose
    mask word is > 0), tests each tile 32 slots at a time, padding slots
    (Ng = 0) skipped, and keeps its 32 rays' running mins apart."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    R, n_tiles, W = rf.shape[0], tri.shape[1] // 128, rows.shape[1]
    t = torch.empty(R)
    for r0 in range(0, R, 32):
        row = rows[r0 // mk.SUBG].tolist()
        if masked:
            walk = [j for j in range(mk.N_FIXED) if row[j] > 0]
        else:
            walk = [i for i in row[1:1 + max(0, min(row[0], W - 1))]
                    if 0 <= i < n_tiles]
        best = torch.full((32,), mk.MISS)
        for tile in walk:
            for piece in range(4):
                cols = tri[:, tile * 128 + piece * 32:][:, :32]
                cols = cols[:, ~(cols[:3] == 0).all(dim=0)]
                if cols.shape[1]:
                    best = torch.minimum(
                        best, mk._mt(rf[r0:r0 + 32], cols).amin(dim=1))
        t[r0:r0 + 32] = best
    return t.reshape(R // 128, 128)


def test_visit_fit_recovers_the_cost_of_a_cast_and_of_a_visit():
    """bench/micro_kernel.visit_fit: the least-squares line through B7a's
    times over L, and fit_line's per-visit and per-test figures, on
    times that lie on a line (3 us a cast, 40 us an L at 131,072 rays)."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    Ls = [0, 1, 2, 4, 8]
    secs = [3e-6 + 40e-6 * L for L in Ls]
    b0, per = mk.visit_fit(Ls[1:], secs[1:])
    assert b0 == pytest.approx(3e-6) and per == pytest.approx(40e-6)
    line = mk.fit_line("B7a", Ls, secs, 131072)
    assert "intercept 3.000 us (L = 0 measured 3.000 us)" in line
    visit_ns, test_ps = (float(x) for x in re.findall(
        r"([\d.]+) (?:ns a visit|ps an MT test)", line))
    assert visit_ns == pytest.approx(40e3 / 2048, abs=1e-4)
    assert test_ps == pytest.approx(40e6 / (131072 * 128), abs=1e-4)


@pytest.mark.parametrize("L", [0, 1, 2, 4, 8])
def test_tile_slope_plain_equals_the_staged_walk_model(L):
    """B7a's mapping (_visit_model) on a table with padding slots and on
    shuffled lists with bad ids and a cut count gives the plain version's
    t bit for bit: a min of f32 values does not depend on the order of the
    tiles nor on their cut into pieces, and a padding slot never hits."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    rf, tri = mk.cast_inputs(2048, 9, L, "cpu")
    tri = _padded_table(tri)
    lists = _odd_tile_lists(mk.tile_lists(2048, L, "cpu"), 9, seed=L)
    want = mk.tile_slope_plain(lists, rf, tri)
    assert torch.equal(_visit_model(lists, rf, tri, False), want)
    # subgroup 0 lists only bad ids beside tiles 0 .. L - 1
    assert bool((want[0, :64] < mk.MISS).any()) == (L > 0)


@pytest.mark.parametrize("frac", [1.0, 0.25, 0.0])
def test_uniform_branch_plain_equals_the_staged_walk_model(frac):
    """B7c's mapping (_visit_model) under masks of positive, zero and
    negative words on a table with padding slots gives the plain
    version's t bit for bit; with every word set it is B7a's at L = 8."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    rf, tri = mk.cast_inputs(2048, 9, 3, "cpu")
    tri = _padded_table(tri)
    mask = _signed_mask(2048 // 64, frac, seed=int(frac * 4))
    want = mk.uniform_branch_plain(mask, rf, tri)
    assert torch.equal(_visit_model(mask, rf, tri, True), want)
    assert bool((want < mk.MISS).any()) == (frac > 0)
    if frac == 1.0:
        assert torch.equal(want, mk.tile_slope_plain(
            mk.tile_lists(2048, 8, "cpu"), rf, tri))


# ------------------------------------------------------------ CUDA cases

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _launched():
    """The wrappers that launched since the last reset, with their counts."""
    return {k: n for k, n in _kernels.LAUNCHES.items() if n}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name,payload,n_out", CLOSEST)
def test_closest_kernel_bitwise_equals_plain(scene, kind, name, payload,
                                             n_out):
    _need_cuda()
    tab, O, u, cap, _, rfT, bits = _cast(scene, kind, 8192, "cuda")
    kernel = getattr(_kernels, name)
    n0 = _kernels.LAUNCHES[name]
    got = kernel(rfT, tab.fields, bits, EPS, SUBG, 128)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == n0 + 1
    want = getattr(pt, f"{name}_plain")(rfT, tab.fields, bits, EPS, SUBG, 128)
    assert len(got) == len(want) == n_out
    for a, b in zip(got, want):
        assert a.is_cuda and torch.equal(a, b)
    assert (want[0] < pt.INF32).any()
    # B0's (t, idx) are B1's
    b1 = _kernels.pairs_closest(rfT, tab.fields, bits, EPS, SUBG, 128)
    assert torch.equal(got[0], b1[0]) and torch.equal(got[1], b1[1])
    # the public query launches the kernel for CUDA tensors
    hit = pt.intersect_tris_pairs(O, u, tab, EPS, cap=cap, subg=SUBG, blk=BLK,
                                  payload=payload)
    if payload:
        hit = hit[0]
    assert _kernels.LAUNCHES[name] == n0 + 2 + (name == "pairs_closest")
    assert torch.equal(hit.t, want[0][:O.x.shape[0]])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_shadow_kernel_bitwise_equals_plain(scene, kind):
    _need_cuda()
    tab, O, u, cap, active, rfT, bits = _cast(scene, kind, 8192, "cuda",
                                              shadow=True)
    n0 = _kernels.LAUNCHES["pairs_shadow"]
    got = _kernels.pairs_shadow(rfT, tab.fields, bits, EPS, SUBG, 128)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["pairs_shadow"] == n0 + 1
    want = pt.pairs_shadow_plain(rfT, tab.fields, bits, EPS, SUBG, 128)
    assert got.is_cuda and torch.equal(got, want)
    t = pt.intersect_tris_pairs_shadow(O, u, tab, EPS, cap=cap, subg=SUBG,
                                       blk=BLK, active=active)
    assert _kernels.LAUNCHES["pairs_shadow"] == n0 + 2
    assert torch.equal(t, want[:O.x.shape[0]])


@pytest.mark.cuda
def test_kernels_break_ties_and_ignore_bits_past_the_table():
    _need_cuda()
    rfT, fields, bits = (x.cuda() for x in _tie_table())
    for name, _, _ in CLOSEST:
        _check_tie(*(x.cpu() for x in getattr(_kernels, name)(
            rfT, fields, bits, EPS, SUBG, 128)))
    t = _kernels.pairs_shadow(rfT, fields, bits, EPS, SUBG, 128)
    assert torch.equal(t.cpu(), torch.full((128,), 5.0))


@pytest.mark.cuda
def test_small_frame_on_cuda_matches_cpu():
    """The 48x48 spp2 d2 frame pads its one 8192-ray cast with 3584
    zero-direction rays: the kernels must take them.  Against the CPU
    frame: the card's log/sin/cos differ in the last bits, so the bound
    is tests/test_golden.py's (fewer than 0.5% of pixels off by more than
    1e-4*|g| + 1.0)."""
    _need_cuda()
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    size = dict(width=48, height=48, spp=2, max_depth=2)
    frames = []
    for dev in ("cpu", "cuda"):
        cfg, tables = build_preset("array_bvh", dev, **size)
        _kernels.reset_launches()
        frames.append(render_preset_frame(tables, cfg, seed=0))
    # the culling of every cast and the ladder's key of the depth-1 casts;
    # a sphere pass on the closest and on the shadow rays, the shading and
    # the bounce at each depth, the primary rays of each sample; each cast's
    # rows (full width, or compacted and scattered back), one composite
    launched = _launched()
    glue = {k: launched.pop(k, 0) for k in (*_kernels.GLUE, "compact_bits")}
    assert launched == {"pairs_closest": 2, "pairs_shadow": 2,
                        "pair_bits": 4 - glue["compact_bits"],
                        "compact_key": 2, "sphere_hit": 4, "shade": 2,
                        "bounce": 2, "primary_rays": 2}
    assert glue["ray_rows"] + glue["compact_bits"] == 4
    assert glue["scatter"] == glue["compact_bits"]
    assert glue["composite"] == 1
    (img_c, st_c), (img_g, st_g) = frames
    assert np.isfinite(img_g).all()
    assert st_g.hit.tolist() == [48 * 48 * 2] * 2
    bad = np.abs(img_g - img_c) > 1e-4 * np.abs(img_c) + 1.0
    assert bad.any(-1).mean() < 0.005


@pytest.mark.cuda
def test_compaction_ladder_on_cuda_is_the_full_width_frame():
    """The 48x48 spp2 d3 frame with casts padded to 128 rays, where the
    compaction ladder's tiers of 0.02 and 0.04 of a cast overflow and
    its third, 0.25, takes each cast at depth >= 1: bitwise the frame
    with every tier at 0, with the same launches of B1 and B2 and of the
    culling (one per cast either way) and the ladder's key on the four
    casts at depth >= 1."""
    _need_cuda()
    import dataclasses

    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    cfg, tables = build_preset("array_bvh", "cuda", width=48, height=48,
                               spp=2, max_depth=3, pairs_block=128,
                               pairs_compact=0.02, pairs_compact2=0.04,
                               pairs_compact3=0.25)
    off = dataclasses.replace(cfg, pairs_compact=0.0, pairs_compact2=0.0,
                              pairs_compact3=0.0)
    frames = []
    for c in (cfg, off):
        _kernels.reset_launches()
        frames.append((render_preset_frame(tables, c, seed=0), _launched()))
    ((img, st), on_launches), ((img0, st0), off_launches) = frames
    off_want = {"pairs_closest": 3, "pairs_shadow": 3, "pair_bits": 6,
                "sphere_hit": 6, "shade": 3, "bounce": 3, "primary_rays": 2,
                "ray_rows": 6, "composite": 1}
    assert off_launches == off_want
    # the depth-0 casts at full width, the four others compacted: their
    # rows and culling one launch (compact_bits)
    assert on_launches == {**off_want, "compact_key": 4, "ray_rows": 2,
                           "pair_bits": 2, "compact_bits": 4, "scatter": 4}
    np.testing.assert_array_equal(img, img0)
    for a, b in zip(st, st0):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("subg", TILED_SUBGS)
@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_kernels_bitwise_equal_plain(scene, kind, capped, subg):
    """B5 and B6 against their plain versions on the same lists, at every
    legal subgroup (below 32 a warp of B6 walks the union of several
    lists); the public queries launch them for CUDA tensors, sorted or
    not."""
    _need_cuda()
    tab, O, u, cap, rfT, lists = _tiled_cast(scene, kind, 8192, "cuda",
                                             capped=capped, subg=subg)
    args = (rfT, tab.fields, lists, EPS, subg)
    n5, n6 = (_kernels.LAUNCHES[k] for k in ("pallas_closest",
                                             "pallas_shadow"))
    got = _kernels.pallas_closest(*args)
    t6 = _kernels.pallas_shadow(*args)
    torch.cuda.synchronize()
    want = pat.pallas_closest_plain(*args)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(t6, pat.pallas_shadow_plain(*args))
    assert (want[0] < pt.INF32).any()
    for sort in (False, True):
        hit = pat.intersect_tris_pallas(O, u, tab, EPS, sort_rays=sort,
                                        cap=cap, subg=subg)
        t = pat.intersect_tris_shadow(O, u, tab, EPS, cap=cap,
                                      sort_rays=sort, subg=subg)
        if not sort:
            assert torch.equal(hit.t, want[0]) and torch.equal(t, t6)
    assert _kernels.LAUNCHES["pallas_closest"] == n5 + 3
    assert _kernels.LAUNCHES["pallas_shadow"] == n6 + 3


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_b5_equals_b0_uncapped_on_cuda(scene, kind):
    """Two kernels, one closest hit (see
    test_tiled_closest_equals_pairs_b0_uncapped)."""
    _need_cuda()
    tab, O, u, _, rfT, lists = _tiled_cast(scene, kind, 8192, "cuda",
                                           capped=False)
    b5 = _kernels.pallas_closest(rfT, tab.fields, lists, EPS, SUBG)
    ptab = pt.PairsMeshTables(*(t.cuda() for t in scene[1].pairs_mesh))
    b0 = pt.intersect_tris_pairs(O, u, ptab, EPS, subg=SUBG, blk=BLK)
    assert torch.equal(b5[0], b0.t) and torch.equal(b5[1], b0.idx)


# rows [count, id, id] of the tie table's lists (2 tiles, L = 3), cycled
# over the subgroups: tile 1 only, an empty row, a count past L - 1 with
# an id outside the table, ids outside the table only, both tiles
# descending, a negative count
_ODD_ROWS = ((1, 1, 0), (0, 0, 1), (9, 1, -1), (2, 7, 2), (2, 1, 0),
             (-3, 0, 1))


@pytest.mark.cuda
def test_tiled_kernels_break_ties_and_skip_bad_ids():
    """B5 breaks the tie table's exact-t tie by the lowest index in either
    list order; B5 and B6 skip ids outside the table and read the first
    min(count, L - 1) ids only, also at subgroups 8 and 16, where a warp
    of B6 spans lists that differ (one names a tile its neighbours do
    not, one is empty)."""
    _need_cuda()
    tab, O, u = _tiled_tie_table()
    rfT = pat._ray_features16(O, u).cuda()
    fields = tab.fields.cuda()
    for order in ([0, 1], [1, 0]):
        lists = torch.tensor([[2] + order] * 2, dtype=torch.int32).cuda()
        t, idx = _kernels.pallas_closest(rfT, fields, lists, EPS, SUBG)
        assert torch.equal(t.cpu(), torch.full((128,), 5.0))
        assert (idx == 5).all()
    lists = torch.tensor([[9, -1, 1], [2, 7, 0]], dtype=torch.int32).cuda()
    args = (rfT, fields, lists, EPS, SUBG)
    got = _kernels.pallas_closest(*args)
    want = pat.pallas_closest_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (got[1][:SUBG] == 200).all() and (got[1][SUBG:] == 5).all()
    assert torch.equal(_kernels.pallas_shadow(*args),
                       pat.pallas_shadow_plain(*args))
    for subg in (8, 16):
        rows = [_ODD_ROWS[i % len(_ODD_ROWS)] for i in range(128 // subg)]
        args = (rfT, fields, torch.tensor(rows, dtype=torch.int32).cuda(),
                EPS, subg)
        got = _kernels.pallas_closest(*args)
        t6 = _kernels.pallas_shadow(*args)
        want = pat.pallas_closest_plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert torch.equal(t6, pat.pallas_shadow_plain(*args))
        hit = (t6 == 5.0).reshape(-1, subg)
        assert torch.equal(hit.all(dim=1).cpu(), torch.tensor(
            [r[0] > 0 and any(0 <= i < 2 for i in r[1:1 + min(r[0], 2)])
             for r in rows]))
        assert (t6[~(t6 == 5.0)] == pt.INF32).all()


@pytest.mark.cuda
@pytest.mark.parametrize("subg", [16, 64])
def test_tiled_kernels_bitwise_on_a_soup_sized_table(subg):
    """B5 and B6 on a table of 1,564 tiles (the 200,000-triangle soup's
    tiled table; the last tile part padding) of small random triangles
    sorted along x, capped rays, at the soup's subgroup and the default:
    bitwise their plain versions."""
    _need_cuda()
    rng = np.random.default_rng(4)
    T = 1564 * 128 - 100
    A = rng.uniform(-20, 20, (T, 3)).astype(np.float32)
    A = A[np.argsort(A[:, 0])]
    B = A + rng.standard_normal((T, 3)).astype(np.float32) * 0.3
    C = A + rng.standard_normal((T, 3)).astype(np.float32) * 0.3
    tab = pat.build_pallas_tables(A, B, C, "cuda")
    assert tab.n_tiles == 1564
    o = rng.uniform(-20, 20, (3, 4096)).astype(np.float32)
    d = rng.standard_normal((3, 4096)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = Vec3(*(torch.from_numpy(c).cuda() for c in o))
    u = Vec3(*(torch.from_numpy(c).cuda() for c in d))
    cap = torch.from_numpy(rng.uniform(1, 10, 4096).astype(np.float32)).cuda()
    rfT, lists, _, _ = pat.cast_inputs(O, u, tab, subg, cap=cap,
                                       sort_rays=True)
    args = (rfT, tab.fields, lists, EPS, subg)
    got = _kernels.pallas_closest(*args)
    t6 = _kernels.pallas_shadow(*args)
    torch.cuda.synchronize()
    want = pat.pallas_closest_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(t6, pat.pallas_shadow_plain(*args))
    assert (t6 < pt.INF32).sum() > 500
    assert 0 < int(lists[:, 0].sum()) < lists.shape[0] * tab.n_tiles


@pytest.mark.cuda
@pytest.mark.parametrize("subg", [8, 16, 32, 64])
def test_tiled_kernels_bitwise_on_ties_and_odd_lists(subg):
    """B5 and B6 against their plain versions where a warp's lanes walk
    lists that differ (below 32 rays a subgroup), on descending lists, ids
    outside the table, an id listed twice, counts past L - 1, exact-t ties
    between tiles and inside one 32-slot piece, and 8,256 rays (not a
    multiple of the 128-thread block: the idle lanes join their warp's
    walk)."""
    _need_cuda()
    R = 8256
    tab, rfT = _tie_mesh(R, seed=subg)
    lists = _odd_lists(tab.n_tiles, R // subg, seed=subg)
    want = pat.pallas_closest_plain(rfT, tab.fields, lists, EPS, subg)
    want6 = pat.pallas_shadow_plain(rfT, tab.fields, lists, EPS, subg)
    args = (rfT.cuda(), tab.fields.cuda(), lists.cuda(), EPS, subg)
    got = _kernels.pallas_closest(*args)
    t6 = _kernels.pallas_shadow(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(t6.cpu(), want6)
    assert int((want[1] == TIE_SLOTS[0]).sum()) > 100
    assert int((want[1] == TIE_SLOTS[2]).sum()
               + (want[1] == TIE_SLOTS[3]).sum()) > 10


@pytest.mark.cuda
@pytest.mark.parametrize("tile_t", [64, 256])
def test_tiled_kernels_refuse_other_tile_widths(tile_t):
    """rt_pallas_closest and rt_pallas_shadow run a compile-time slot loop
    over 128-slot tiles and return cudaErrorInvalidValue (1) for any other
    width, launching nothing."""
    _need_cuda()
    lib = _kernels.load()
    R, Tp, subg = 256, 512, 64
    rfT = torch.zeros(16, R, device="cuda")
    fields = torch.zeros(16, Tp, device="cuda")
    lists = torch.zeros(R // subg, 1 + Tp // tile_t, dtype=torch.int32,
                        device="cuda")
    t = torch.full((R,), -1.0, device="cuda")
    idx = torch.full((R,), -1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for cfun, outs in (("rt_pallas_closest", (t, idx)),
                       ("rt_pallas_shadow", (t,))):
        err = getattr(lib, cfun)(
            rfT.data_ptr(), fields.data_ptr(), lists.data_ptr(), R, Tp,
            lists.shape[1], subg, tile_t, EPS,
            *(o.data_ptr() for o in outs), stream)
        assert err == 1, cfun
    torch.cuda.synchronize()
    assert (t == -1.0).all() and (idx == -1).all()


@pytest.mark.cuda
def test_small_pallas_frame_on_cuda_matches_cpu():
    """The 48x48 spp2 d2 frame through the tiled traversal: one 5120-ray
    cast per depth (4608 rays and 512 zero-direction padding rays), B5 and
    B6 once each per cast, each cast culled once (tile_lists) and its rows
    built once (ray_rows), one composite; the bound of
    test_small_frame_on_cuda_matches_cpu against the CPU frame."""
    _need_cuda()
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    size = dict(width=48, height=48, spp=2, max_depth=2, traversal="pallas")
    frames = []
    for dev in ("cpu", "cuda"):
        cfg, tables = build_preset("array_bvh", dev, **size)
        _kernels.reset_launches()
        frames.append(render_preset_frame(tables, cfg, seed=0))
    assert _launched() == {"pallas_closest": 2, "pallas_shadow": 2,
                           "tile_lists": 4, "sphere_hit": 4, "shade": 2,
                           "bounce": 2, "primary_rays": 2, "ray_rows": 4,
                           "composite": 1}
    (img_c, _), (img_g, st_g) = frames
    assert np.isfinite(img_g).all()
    assert st_g.hit.tolist() == [48 * 48 * 2] * 2
    bad = np.abs(img_g - img_c) > 1e-4 * np.abs(img_c) + 1.0
    assert bad.any(-1).mean() < 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("subg", [16, 64])
@pytest.mark.parametrize("name", ["pairs_closest", "pairs_closest_smooth",
                                  "pairs_closest_idx", "pairs_shadow"])
def test_kernels_bitwise_past_st_slots(name, subg):
    """B0-B3 on a table past 32,768 slots (301 tiles; the JAX package's B4
    sizes) with bits naming tiles past the table: bitwise their plain
    versions, at the subgroups the presets use."""
    _need_cuda()
    rfT, fields, bits = (x.cuda() for x in _big_table(subg=subg))
    assert fields.shape[1] > 32768
    got = getattr(_kernels, name)(rfT, fields, bits, EPS, subg, 128)
    torch.cuda.synchronize()
    want = getattr(pt, f"{name}_plain")(rfT, fields, bits, EPS, subg, 128)
    if name == "pairs_shadow":
        got, want = (got,), (want,)
    assert all(a.is_cuda and torch.equal(a, b) for a, b in zip(got, want))
    assert (want[0] < pt.INF32).sum() > 100


@pytest.mark.cuda
@pytest.mark.parametrize("tile_t", [32, 64, 128, 256])
@pytest.mark.parametrize("subg", [16, 32, 64, 128])
def test_kernels_bitwise_at_every_subgroup_and_tile_width(subg, tile_t):
    """B0-B3 bitwise their plain versions on a synthetic cast at each
    subgroup and at tile widths of 1 to 8 pieces of 32 slots; exact-t ties
    between tiles, bits past the table.  Below subgroup 128 the cast's
    8,640 rays end in half a block of 128 threads, whose idle lanes still
    join their warp's walk; at 128 it is 8,576 rays, whole subgroups."""
    _need_cuda()
    R = 8576 + (64 if subg <= 64 else 0)
    rfT, fields, bits = (x.cuda() for x in _synthetic_cast(
        tile_t=tile_t, R=R, subg=subg))
    args = (rfT, fields, bits, EPS, subg, tile_t)
    for name in PAIRS_KERNELS:
        got = getattr(_kernels, name)(*args)
        got = got if isinstance(got, tuple) else (got,)
        torch.cuda.synchronize()
        want = _outputs(name, args)
        assert all(a.is_cuda and torch.equal(a, b)
                   for a, b in zip(got, want)), name
        assert (want[0] < pt.INF32).sum() > 1000


def _probe_cast(R=8192, n_tiles=9, seed=0):
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    return (mk, *mk.cast_inputs(R, n_tiles, seed, "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 1, 2, 4, 8])
def test_probe_tile_slope_bitwise_equals_plain(L):
    _need_cuda()
    mk, rf, tri = _probe_cast()
    lists = mk.tile_lists(rf.shape[0], L, "cuda")
    lists[3, 1] = 77   # no such tile: skipped
    lists[5, 0] = 500  # cut at the row's width
    n0 = _kernels.LAUNCHES["probe_tile_slope"]
    got = mk.tile_slope(lists, rf, tri)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_tile_slope"] == n0 + 1
    want = mk.tile_slope_plain(lists, rf, tri)
    assert got.is_cuda and torch.equal(got, want)
    assert bool((got[0] == mk.MISS).all()) == (L == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [1.0, 0.25, 0.0])
def test_probe_uniform_branch_bitwise_equals_plain(frac):
    _need_cuda()
    mk, rf, tri = _probe_cast()
    g = torch.Generator().manual_seed(1)
    mask = (torch.rand(rf.shape[0] // 64, 128, generator=g)
            < frac).to(torch.int32).cuda()
    got = mk.uniform_branch(mask, rf, tri)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.uniform_branch_plain(mask, rf, tri))
    if frac == 1.0:
        assert torch.equal(got, mk.tile_slope(
            mk.tile_lists(rf.shape[0], 8, "cuda"), rf, tri))
    if frac == 0.0:
        assert (got == mk.MISS).all()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 1, 2, 4, 8])
def test_probe_tile_slope_bitwise_on_shuffled_lists_and_padding(L):
    """B7a on shuffled lists with bad ids and a count past the row's width
    (_odd_tile_lists), over a table with padding slots: bitwise the plain
    version, one launch."""
    _need_cuda()
    mk, rf, tri = _probe_cast()
    tri = _padded_table(tri)
    lists = _odd_tile_lists(mk.tile_lists(rf.shape[0], L, "cpu"), 9,
                            seed=L).cuda()
    n0 = _kernels.LAUNCHES["probe_tile_slope"]
    got = mk.tile_slope(lists, rf, tri)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_tile_slope"] == n0 + 1
    assert got.is_cuda and torch.equal(got, mk.tile_slope_plain(lists, rf,
                                                                tri))
    assert bool((got[0, :64] < mk.MISS).any()) == (L > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("frac", [1.0, 0.25, 0.0])
def test_probe_uniform_branch_bitwise_on_padding_and_signed_words(frac):
    """B7c under masks of positive, zero and negative words, over a table
    with padding slots: bitwise the plain version."""
    _need_cuda()
    mk, rf, tri = _probe_cast()
    tri = _padded_table(tri)
    mask = _signed_mask(rf.shape[0] // 64, frac, seed=int(frac * 4)).cuda()
    got = mk.uniform_branch(mask, rf, tri)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.uniform_branch_plain(mask, rf, tri))
    assert bool((got < mk.MISS).any()) == (frac > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("subg", [16, 48])
def test_probe_visits_refuse_subgroups_off_the_warp(subg):
    """rt_probe_tile_slope and rt_probe_uniform_branch walk one subgroup a
    warp and return cudaErrorInvalidValue (1) for a subgroup that is not a
    multiple of 32, launching nothing."""
    _need_cuda()
    lib = _kernels.load()
    R, Tp = 384, 9 * 128
    rf = torch.zeros(R, 16, device="cuda")
    tri = torch.zeros(16, Tp, device="cuda")
    rows = torch.ones(R // subg, 128, dtype=torch.int32, device="cuda")
    t = torch.full((R,), -1.0, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    head = (rows.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp, 128, subg)
    assert lib.rt_probe_tile_slope(*head, t.data_ptr(), stream) == 1
    assert lib.rt_probe_uniform_branch(*head, 8, t.data_ptr(), stream) == 1
    torch.cuda.synchronize()
    assert (t == -1.0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 1, 4])
@pytest.mark.parametrize("subg", [8, 16, 32, 64])
def test_probe_pair_slope_bitwise_equals_plain(subg, L):
    _need_cuda()
    mk, rf, tri = _probe_cast()
    pairs = mk.pair_lists(rf.shape[0], 9, subg, L, "cuda")
    if L:
        pairs[:, 2] = -3                         # skipped
        pairs[1, 3] = (1024 // subg) * 256       # no such subgroup: skipped
        pairs[2, 1] = 200                        # no such tile: skipped
    got = mk.pair_slope(pairs, rf, tri, subg)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.pair_slope_plain(pairs, rf, tri, subg))
    assert bool((got == mk.MISS).all()) == (L == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [0, 1, 2, 4])
@pytest.mark.parametrize("subg", [1, 2, 4, 8, 16, 32, 64, 128])
def test_probe_pair_slope_bitwise_on_shuffled_lists(subg, L):
    """B7e against its plain version at every subgroup its template
    covers (kM = 32, 16, 8, 4, 2 lanes a ray, and 1 from 32 rays on) and
    each L, on lists whose pairs come in random order, with a pair listed
    twice, bad pairs and a count past the row's width."""
    _need_cuda()
    mk, rf, tri = _probe_cast()
    pairs = _shuffled_pairs(mk.pair_lists(rf.shape[0], 9, subg, L, "cpu"),
                            9, subg, seed=subg + L).cuda()
    n0 = _kernels.LAUNCHES["probe_pair_slope"]
    got = mk.pair_slope(pairs, rf, tri, subg)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["probe_pair_slope"] == n0 + 1
    assert torch.equal(got, mk.pair_slope_plain(pairs, rf, tri, subg))
    assert bool((got == mk.MISS).all()) == (L == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1024, 131072, 524288])
def test_probe_block_mask_and_row_gather_are_exact(R):
    """B7b and its control (one 1024-thread block a 1024-row block) give
    2 x exactly at one block, at the entry point's default and at the
    main path's cast size; B7d gathers exactly."""
    _need_cuda()
    mk, rf, _ = _probe_cast(R=R)
    n0 = _kernels.LAUNCHES["probe_block_mask"]
    for mask in (True, False):
        assert torch.equal(mk.block_mask(rf, mask), rf * 2.0)
    assert _kernels.LAUNCHES["probe_block_mask"] == n0 + 2
    g = torch.Generator().manual_seed(2)
    table = torch.rand(mk.GATHER_ROWS, 128, generator=g).cuda()
    idx = torch.randint(0, mk.GATHER_ROWS, (8192, 1), generator=g,
                        dtype=torch.int32).cuda()
    got = mk.row_gather(idx, table)
    torch.cuda.synchronize()
    assert torch.equal(got, table[idx[:, 0].long()])


@pytest.mark.cuda
def test_probe_main_runs_and_checks_every_probe(capsys):
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk

    _kernels.reset_launches()
    res = mk.main(["--rays", "8192", "--iters", "3"])
    assert list(res) == list(mk.BENCHES)
    assert set(_launched()) == set(_kernels.PROBES)
    assert all(c["plain_s"] > 0 for c in res["slope"])


# ----------------------------- the cpu preset's lost rays, on the card

CPU_FRAME = dict(width=512, height=512, spp=8, max_depth=5)


def find_cpu_preset_lost_rays(device):
    """The lanes of the ``cpu`` preset's 512x512 spp 8 depth 5 seed 0 frame
    in which a ray misses everything: [[row, sample, rays lost per depth],
    ...], found by halving the rows of each sample (``render_rows`` keys a
    ray by its sample and its row, so a row rendered alone casts the rays
    it casts in the frame)."""
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_rows

    cfg, tab = build_preset("cpu", device, **CPU_FRAME)
    cam, key = Camera.default(cfg, device), PRNGKey(0, device)
    found = []

    def search(rows, s):
        hit = render_rows(tab, cfg, cam, key, rows, [s])[1].hit
        lost = (len(rows) * cfg.width - hit).tolist()
        if not any(lost):
            return
        if len(rows) == 1:
            found.append([int(rows[0]), s, lost])
            return
        h = len(rows) // 2
        search(rows[:h], s)
        search(rows[h:], s)

    for s in range(cfg.spp):
        search(np.arange(cfg.height, dtype=np.int32), s)
    return found


@pytest.mark.cuda
def test_cpu_preset_loses_the_recorded_rays_on_the_card():
    """tests/golden/cpu_512_lost_rays.json records the lanes found here;
    tests/test_torch_presets.py renders them through both packages on the
    CPU, and chip_smoke.py holds the frame to their per-depth sums."""
    import json
    import os

    _need_cuda()
    with open(os.path.join(os.path.dirname(__file__), "golden",
                           "cpu_512_lost_rays.json")) as f:
        rec = json.load(f)
    found = find_cpu_preset_lost_rays("cuda")
    assert found == rec["lanes"], found
    n = CPU_FRAME["width"] * CPU_FRAME["height"] * CPU_FRAME["spp"]
    assert [n - sum(lane[2][d] for lane in found)
            for d in range(CPU_FRAME["max_depth"])] == rec["hits_per_depth"]


# ------------------------- the pairs culling (csrc/cull.cu), CPU and CUDA

def _culling_inputs(device, R=4096, n_boxes=1100, n_tiles=300, seed=0):
    """bench/cull.py's adversarial rays and boxes as tensors on device:
    (O, u, boxes, tiles, cap, active)."""
    from raytracinggpu_tpu_torch.bench.cull import adversarial

    O, d, boxes, tiles, cap, act = adversarial(seed, R, n_boxes, n_tiles)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (Vec3(*map(t, O)), Vec3(*map(t, d)), t(boxes), t(tiles), t(cap),
            t(act))


@pytest.mark.parametrize("bad,why", [
    ("dtype", "float32"), ("cap", "float32"), ("active", "bool"),
    ("tile dtype", "int32"), ("columns", "6 columns"),
    ("subgroup", "does not divide"), ("device", "CUDA"),
    ("key boxes", "key boxes"), ("mode", "key mode")])
def test_culling_wrappers_check_their_inputs(bad, why):
    """The culling wrappers take CUDA tensors only (a CPU tensor's place is
    the plain version in ops/pairs_trace.py) and refuse a wrong dtype,
    shape or device before anything is built or launched."""
    R, nb = 256, 8
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    O = Vec3(*(meta(R) for _ in range(3)))
    u = Vec3(*(meta(R) for _ in range(3)))
    boxes, tiles = meta(nb, 8), meta(nb, dt=torch.int32)
    cap, act = meta(R), meta(R, dt=torch.bool)
    cpu = Vec3(*(torch.zeros(R) for _ in range(3)))
    bits = lambda *a, **k: _kernels.pair_bits(*a, **k)
    key = lambda *a: _kernels.compact_key(*a)
    calls = {
        "dtype": lambda: bits(Vec3(O.x.double(), O.y, O.z), u, 40, 16,
                              (boxes, tiles)),
        "cap": lambda: bits(O, u, 40, 16, (boxes, tiles), meta(R - 1)),
        "active": lambda: bits(O, u, 40, 16, (boxes, tiles), cap,
                               meta(R)),
        "tile dtype": lambda: bits(O, u, 40, 16, (boxes, tiles.long())),
        "columns": lambda: key(O, u, meta(nb, 5), nb, 2, 20, None, None, R),
        "subgroup": lambda: bits(O, u, 40, 48, (boxes, tiles)),
        "device": lambda: bits(cpu, cpu, 40, 16, (torch.zeros(nb, 8),
                                                   tiles.new_zeros(nb,
                                                                   device="cpu"))),
        "key boxes": lambda: key(O, u, boxes, nb + 1, 2, 20, cap, act, R),
        "mode": lambda: key(O, u, boxes, nb, 3, 20, cap, act, R),
    }
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=why):
        calls[bad]()
    assert _kernels.LAUNCHES == before


def _check_culling(O, u, members, nc, cap, active, subg, key_sets, valid_n):
    """Both culling kernels on CUDA tensors against their plain versions,
    bitwise: pair_bits over ``members``, and for each (boxes, n) of
    ``key_sets`` the key of ``ops/pairs_trace._compact_key``; each launch
    counted once.  Returns the key modes taken."""
    n0 = dict(_kernels.LAUNCHES)
    got = pt._pair_bits(O, u, nc, subg, members, cap, active)
    torch.cuda.synchronize()
    want = pt.pair_bits_plain(O, u, nc, subg, members, cap, active)
    assert got.is_cuda and got.dtype == torch.int32
    assert torch.equal(got, want)
    modes = set()
    for boxes, n in key_sets:
        skey, n_act, shift = pt._compact_key(O, u, boxes, n, cap, active,
                                             valid_n)
        torch.cuda.synchronize()
        wkey, wn, wshift = pt.compact_key_plain(O, u, boxes, n, cap, active,
                                                valid_n)
        assert shift == wshift and torch.equal(skey, wkey)
        assert n_act.is_cuda and n_act.dtype == torch.int64 \
            and n_act.dim() == 0 and int(n_act) == int(wn)
        modes.add(pt._key_mode(n, O.x.shape[0])[0])
    assert _kernels.LAUNCHES["pair_bits"] == n0["pair_bits"] + 1
    assert _kernels.LAUNCHES["compact_key"] == n0["compact_key"] \
        + len(key_sets)
    return modes


@pytest.mark.cuda
@pytest.mark.parametrize("with_cap,with_active", [(False, False),
                                                  (True, False),
                                                  (True, True)])
@pytest.mark.parametrize("subg", [16, 32, 64])
@pytest.mark.parametrize("kind", KINDS)
def test_culling_kernels_bitwise_equal_plain(scene, kind, subg, with_cap,
                                             with_active):
    """rt_pair_bits over the cat's member boxes and rt_compact_key over its
    tile boxes and their unions of 4, bitwise the plain versions on the
    cast of each kind, the last 100 lanes padding for the key."""
    _need_cuda()
    tab, O, u, cap, active, _, _ = _cast(scene, kind, 8192, "cuda",
                                         shadow=True)
    nc = tab.tile_aabb.shape[0]
    coarse, knc = pt._coarse_aabb(tab.tile_aabb, nc, 4)
    _check_culling(O, u, (tab.member_aabb, tab.member_tile), nc,
                   cap if with_cap else None,
                   active if with_active else None, subg,
                   ((tab.tile_aabb, nc), (coarse, knc)), 8192 - 100)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("subg", [16, 32, 64, 128])
def test_culling_kernels_bitwise_on_adversarial_rays(subg, seed):
    """bench/cull.py's rays (exactly-zero and -0.0 direction components,
    origins on box faces, zero-thickness boxes, caps at an enter distance)
    over 1,100 member boxes of 300 tiles (three chunks of the kernel's
    staged boxes, bit 31 set): pair_bits bitwise, with and without cap and
    active; the key over 40 boxes (mode 2) and 1,100 (mode 1)."""
    _need_cuda()
    O, u, boxes, tiles, cap, act = _culling_inputs("cuda", seed=seed)
    modes = set()
    for c, a in ((None, None), (cap, None), (None, act), (cap, act)):
        modes |= _check_culling(O, u, (boxes, tiles), 300, c, a, subg,
                                ((boxes[:40].contiguous(), 40),
                                 (boxes, 1100)), 4096 - 7)
    assert modes == {1, 2}


@pytest.mark.cuda
def test_culling_kernels_on_a_wide_table_and_the_compacted_rows():
    """A bitmask past one pass of the kernel's shared words (5,000 tiles,
    157 words, at subgroup 2: a block holds 32 words of its 128 subgroups
    at a time), and rays read as the rows of a compacted cast's (11, C)
    ray rows, as _rows_bits passes them: bitwise the plain versions."""
    _need_cuda()
    O, u, boxes, tiles, cap, act = _culling_inputs("cuda", n_tiles=5000)
    _check_culling(O, u, (boxes, tiles), 5000, cap, act, 2, (), 4096)
    rows = pt._live_rows(O, u, cap, act)
    Or, ur = Vec3(rows[6], rows[7], rows[8]), Vec3(rows[0], rows[1], rows[2])
    _check_culling(Or, ur, (boxes, tiles), 5000, rows[9], rows[10] > 0.5,
                   64, ((boxes[:40].contiguous(), 40),), 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["subgroups", "wide table", "keys",
                                  "tiles"])
def test_culling_kernels_bitwise_on_the_index_cases(part):
    """bench/cull.index_cases: pair_bits at subgroups 8, 16, 32, 64, 128
    and 512 (wider than a block) over 37 subgroups (rays no multiple of
    the rays a block holds), 1,100 member boxes (several staging chunks)
    and members naming tiles outside [0, nc); over 5,000 tiles (several
    passes of a block's words) at subgroups 2 and 8; the key on 5,000 rays
    over 40, 129 (one past a staging chunk) and 1,100 boxes; tile_lists at
    subgroups 1-128 over 300 tiles, 5,000 (passes) and 140,000 (past
    131,072): each through the wrapper (counted) and at every
    rays-a-thread the kernels take (1, 2, 4 where it divides the
    subgroup), bitwise the plain version."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench.cull import SUBGROUPS, index_cases
    from raytracinggpu_tpu_torch.bench.cull_design import hold_index_cases

    cases = [c for c in index_cases("cuda")
             if {"subgroups": c[1] == "pair_bits" and "5,000" not in c[0],
                 "wide table": "5,000 tiles" in c[0],
                 "keys": c[1] == "compact_key",
                 "tiles": c[1] == "tile_lists"}[part]]
    n0 = dict(_kernels.LAUNCHES)
    held = hold_index_cases(cases)
    assert [(label, k) for label, k, ok in held if not ok] == []
    name = {"keys": "compact_key", "tiles": "tile_lists"}.get(part,
                                                               "pair_bits")
    assert _kernels.LAUNCHES[name] == n0[name] + len(cases)
    assert {k for _, k, _ in held} == {None, 1, 2, 4}
    if part == "subgroups":
        assert {c[2][3] for c in cases} == set(SUBGROUPS)
        assert all(c[2][0].x.shape[0] % 512 for c in cases if c[2][3] < 512)


@pytest.mark.cuda
def test_compact_key_is_one_launch_and_its_count_resets():
    """rt_compact_key runs one device operation a call (the count lands in
    n_act from the kernel's last block; no memset: a CUDA graph capturing
    a call holds one kernel node), and n_act is the plain count over three
    calls in a row and over two replays of one captured CUDA graph: the
    counter and the ticket are back at zero after each."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench.cull_design import graph_nodes

    O, u, boxes, _, cap, act = _culling_inputs("cuda", R=70000)
    args = (O, u, boxes[:40].contiguous(), 40, cap, act, 69000)
    want = pt.compact_key_plain(*args)
    assert graph_nodes(lambda: pt._compact_key(*args)) == [0]
    for _ in range(3):
        skey, n_act, shift = pt._compact_key(*args)
        assert torch.equal(skey, want[0]) and int(n_act) == int(want[1])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = pt._compact_key(*args)
    for _ in range(2):
        captured[1].fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured[0], want[0])
        assert int(captured[1]) == int(want[1]) > 0


# -------------------------- the tiled culling (csrc/cull.cu rt_tile_lists)

@pytest.mark.parametrize("bad,why", [
    ("dtype", "float32"), ("cap", "float32"), ("columns", "6 columns"),
    ("no tiles", "n_tiles"), ("short table", "n_tiles"),
    ("subgroup", "does not divide"), ("device", "CUDA")])
def test_tile_lists_wrapper_checks_its_inputs(bad, why):
    """The tiled culling's wrapper takes CUDA tensors only (a CPU tensor's
    place is ops/pallas_trace.block_active_tiles_plain) and refuses a
    wrong dtype, shape or device before anything is built or launched."""
    R, nt = 256, 40
    meta = lambda *shape, dt=torch.float32: torch.empty(shape, dtype=dt,
                                                        device="meta")
    O = Vec3(*(meta(R) for _ in range(3)))
    aabb = meta(nt, 8)
    cpu = Vec3(*(torch.zeros(R) for _ in range(3)))
    lists = _kernels.tile_lists
    calls = {
        "dtype": lambda: lists(Vec3(O.x, O.y.double(), O.z), O, aabb, nt,
                               None, 64),
        "cap": lambda: lists(O, O, aabb, nt, meta(R, dt=torch.float64), 64),
        "columns": lambda: lists(O, O, meta(nt, 5), nt, None, 64),
        "no tiles": lambda: lists(O, O, aabb, 0, None, 64),
        "short table": lambda: lists(O, O, aabb, nt + 1, None, 64),
        "subgroup": lambda: lists(O, O, aabb, nt, None, 48),
        "device": lambda: lists(cpu, cpu, torch.zeros(nt, 8), nt, None, 64),
    }
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=why):
        calls[bad]()
    assert _kernels.LAUNCHES == before


def _check_tile_lists(O, u, aabb, n_tiles, cap, subg):
    """rt_tile_lists on CUDA tensors against the plain version, bitwise,
    one launch counted; returns the rows."""
    n0 = _kernels.LAUNCHES["tile_lists"]
    got = pat._block_active_tiles(O, u, aabb, n_tiles, cap=cap, subg=subg)
    torch.cuda.synchronize()
    want = pat.block_active_tiles_plain(O, u, aabb, n_tiles, cap=cap,
                                        subg=subg)
    assert got.is_cuda and got.dtype == torch.int32
    assert got.shape == (O.x.shape[0] // subg, 1 + n_tiles)
    assert torch.equal(got, want)
    assert _kernels.LAUNCHES["tile_lists"] == n0 + 1
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("subg", (1, 4) + TILED_SUBGS)
@pytest.mark.parametrize("kind", KINDS)
def test_tile_lists_bitwise_equal_plain(scene, kind, subg, capped):
    """rt_tile_lists over the cat's 32 tile boxes (one of them the padding
    tile's inverted box) on 8,192 rays of each kind, at every subgroup the
    tiled traversal admits, capped by the spheres or not: bitwise the plain
    version; the padding tile is never active."""
    _need_cuda()
    tab, O, u, cap, _, _ = _tiled_cast(scene, kind, 8192, "cuda",
                                       capped=capped, subg=subg)
    rows = _check_tile_lists(O, u, tab.tile_aabb, tab.n_tiles, cap, subg)
    assert (rows[:, 0] < tab.n_tiles).all() and rows[:, 0].max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [4, 31, 32, 33, 126, 127, 300])
@pytest.mark.parametrize("subg", [1, 4, 16, 64, 128])
def test_tile_lists_bitwise_on_adversarial_tables(subg, n_tiles):
    """bench/cull.adversarial_tiles (signed-zero directions, origins on
    faces, padding tiles' inverted boxes, NaN in lo.x, hi.x and another
    coordinate, a box of infinite extent, caps at an enter distance) on
    4,096 rays: bitwise the plain version with and without cap."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench.cull import adversarial_tiles

    O, d, aabb, cap = adversarial_tiles(n_tiles + subg, 4096, n_tiles)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    O, u, aabb, cap = Vec3(*map(t, O)), Vec3(*map(t, d)), t(aabb), t(cap)
    for c in (None, cap):
        _check_tile_lists(O, u, aabb, n_tiles, c, subg)


@pytest.mark.cuda
def test_tile_lists_read_a_posed_table_on_every_call():
    """The tiled culling reads its boxes (and their validity) on every
    call: the animated realtime scene posed at two angles gives other
    tile boxes, and the kernel's rows equal the plain version's on each,
    as on the unposed table."""
    _need_cuda()
    from raytracinggpu_tpu_torch.scene.transform import pose_mesh

    cfg, tables = build_preset("realtime", "cuda", animate_mesh=True,
                               traversal="pallas")
    O, u = _rays("scattered", cfg, tables, 8192)
    O = Vec3(*(c.to("cuda") for c in O))
    u = Vec3(*(c.to("cuda") for c in u))
    seen = []
    for angle in (0.0, 0.9, 2.1):
        c, s = math.cos(angle), math.sin(angle)
        posed = pose_mesh(tables, [[c, 0.0, s], [0.0, 1.0, 0.0],
                                   [-s, 0.0, c]])
        tab = posed.pallas_mesh
        rows = _check_tile_lists(O, u, tab.tile_aabb, tab.n_tiles, None, 64)
        seen.append(rows)
    assert not torch.equal(seen[1], seen[2])


@pytest.mark.cuda
def test_tile_lists_replay_from_a_cuda_graph():
    """One call is one kernel where a block holds its subgroups' words in
    one pass (300 tiles), two (the words, then the rows) where it does not
    (5,000 tiles at subgroup 1), and no memset: a CUDA graph capturing it
    holds that many kernel nodes, and its replays give the plain rows
    again."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench.cull import adversarial_tiles
    from raytracinggpu_tpu_torch.bench.cull_design import graph_nodes

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")
    for n_rays, n_tiles, subg, nodes in ((70000 // 64 * 64, 300, 64, [0]),
                                         (4099, 5000, 1, [0, 0])):
        O, d, aabb, cap = adversarial_tiles(3, n_rays, n_tiles)
        O, u, aabb, cap = Vec3(*map(t, O)), Vec3(*map(t, d)), t(aabb), t(cap)
        args = (O, u, aabb, n_tiles, cap, subg)
        want = pat.block_active_tiles_plain(*args)
        assert graph_nodes(lambda: pat._block_active_tiles(*args)) == nodes
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = pat._block_active_tiles(*args)
        for _ in range(2):
            captured.fill_(-1)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(captured, want)


# -------------- the depth step and the primary rays (csrc/wavefront.cu)

def _depth_step_calls(bad):
    """One call of each depth-step wrapper on meta tensors, with ``bad``
    applied to one input of the wrapper it names (see the test below)."""
    R, S, M = 256, 6, 7
    f32 = torch.float32
    meta = lambda *shape, dt=f32: torch.empty(shape, dtype=dt,
                                              device="meta")
    v3 = lambda: Vec3(*(meta(R) for _ in range(3)))
    O, u = v3(), v3()
    spheres = tuple(meta(S) for _ in range(4))
    mats = ((meta(M), meta(M), meta(M)), meta(M, dt=torch.bool), meta(M),
            meta(M))
    L = tuple(meta() for _ in range(3))
    counts = meta(6, dt=torch.int64)
    sph = (meta(R), meta(R, dt=torch.int32), v3())
    mesh = (meta(R), v3())
    cam = tuple(meta() for _ in range(12))
    key = (meta(dt=torch.int64), meta(dt=torch.int64))
    rows = meta(2, dt=torch.int64)
    W = R // 2
    if bad == "sphere_hit dtype":
        O = Vec3(O.x.double(), O.y, O.z)
    elif bad == "sphere_hit table":
        spheres = spheres[:3] + (meta(S + 1),)
    elif bad == "sphere_hit shadow mode":
        return lambda: _kernels.sphere_hit(O, u, spheres, full=True,
                                           active=meta(R, dt=torch.bool),
                                           lv2=meta(R))
    elif bad == "shade shape":
        sph = (meta(R + 1),) + sph[1:]
    elif bad == "shade obj dtype":
        sph = (sph[0], meta(R, dt=torch.int64), sph[2])
    elif bad == "shade contiguity":
        mesh = (torch.empty(2 * R, device="meta")[::2], mesh[1])
    elif bad == "shade counts":
        counts = meta(5, dt=torch.int64)
    elif bad == "shade light":
        L = (meta(1),) + L[1:]
    elif bad == "bounce albedo":
        alb = meta(R, 3)
        return lambda: _kernels.bounce(u, O, alb, meta(R), meta(R),
                                       meta(R, dt=torch.bool),
                                       meta(R, dt=torch.bool), meta(R), None,
                                       meta(R), meta(R), counts)
    elif bad == "primary_rays buffer":
        return lambda: _kernels.primary_rays(
            key, 0, rows, cam, W, 3, False, 0.2, 64.0, 64.0, -110.0, O, u,
            meta(3, R, 2).transpose(1, 2))
    elif bad == "primary_rays key":
        key = (meta(1, dt=torch.int64), key[1])
    kernel = bad.split()[0]
    if kernel == "sphere_hit":
        return lambda: _kernels.sphere_hit(O, u, spheres)
    if kernel == "shade":
        return lambda: _kernels.shade(O, u, meta(R), sph, mesh, mats, L,
                                      meta(), 1e-4, 6, counts)
    if kernel == "bounce":
        return lambda: _kernels.bounce(u, O, meta(3, R), meta(R), meta(R),
                                       meta(R, dt=torch.bool),
                                       meta(R, dt=torch.bool), meta(R),
                                       meta(R), meta(R), meta(R), counts)
    return lambda: _kernels.primary_rays(key, 0, rows, cam, W, 3, False, 0.2,
                                         64.0, 64.0, -110.0, O, u,
                                         meta(3, 2, R))


@pytest.mark.parametrize("bad,why", [
    ("sphere_hit dtype", "O.x: need a contiguous"),
    ("sphere_hit table", "radius: need a contiguous"),
    ("sphere_hit shadow mode", "shadow mode"),
    ("shade shape", "t_s: need a contiguous"),
    ("shade obj dtype", "obj: need a contiguous"),
    ("shade contiguity", "t_m: need a contiguous"),
    ("shade counts", "counts: need a contiguous"),
    ("shade light", r"L.x: need a contiguous .* shape \(\)"),
    ("bounce albedo", r"alb: need a contiguous \(3, 256\)"),
    ("primary_rays buffer", "un a"),
    ("primary_rays key", "k0: need a contiguous"),
    ("sphere_hit device", "one CUDA device"),
    ("shade device", "one CUDA device"),
    ("bounce device", "one CUDA device"),
    ("primary_rays device", "one CUDA device")])
def test_depth_step_wrappers_check_their_inputs(bad, why):
    """The depth-step wrappers refuse a wrong dtype, shape, contiguity or
    device before anything is built or launched; well-formed tensors that
    are not on a CUDA device (here meta tensors) are refused last."""
    assert set(_kernels.DEPTH_STEP) <= set(_kernels.LAUNCHES)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=why):
        _depth_step_calls(bad)()
    assert _kernels.LAUNCHES == before


DEPTH_FRAMES = {"array_bvh pairs": ("array_bvh", {}),
                "array_bvh pallas": ("array_bvh", dict(traversal="pallas")),
                "realtime": ("realtime", {}), "showcase": ("showcase", {})}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", list(DEPTH_FRAMES))
def test_depth_step_kernels_bitwise_equal_plain(frame):
    """On the calls of a 64x64 spp4 d3 frame (depths 0 and 1, samples 0
    and 1) and on bench/depth_step.py's hard inputs, each kernel of
    csrc/wavefront.cu equals its plain version bit for bit; the frame
    equals the frame with the plain stages patched in, which launches
    none of them."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import depth_step as ds
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    name, kw = DEPTH_FRAMES[frame]
    cfg, tables = build_preset(name, "cuda", width=64, height=64, spp=4,
                               max_depth=3, **kw)
    _kernels.reset_launches()
    kept, (img, st) = ds.capture(lambda: render_preset_frame(tables, cfg, 0))
    depth = {k: _kernels.LAUNCHES[k] for k in _kernels.DEPTH_STEP}
    assert depth == {"sphere_hit": 6, "shade": 3, "bounce": 3,
                     "primary_rays": 4}
    err = {}
    assert all(r[-1] for r in ds.hold(kept, frame, err, quiet=True))
    assert ds.hold_calls(ds.adversarial_calls(tables, cfg), frame, err)
    with ds.plain_stages():
        _kernels.reset_launches()
        img_p, st_p = render_preset_frame(tables, cfg, 0)
    assert not any(_kernels.LAUNCHES[k] for k in _kernels.DEPTH_STEP)
    np.testing.assert_array_equal(img, img_p)
    for a, b in zip(st, st_p):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_sphere_hit_bitwise_on_edge_lanes(seed):
    """bench/depth_step.sphere_edge_calls: the bounds of rt_sphere_hit's
    fast loop, deltas under 2^-126, a table its check refuses, two chunks
    of its shared table."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import depth_step as ds

    _, tables = build_preset("array_bvh", "cuda")
    calls = ds.sphere_edge_calls(tables.spheres, seed=seed)
    assert ds.hold_calls(calls, f"seed {seed}", {})


@pytest.mark.cuda
@pytest.mark.parametrize("first", [0, 0x3F000000, 0x7F7F0000, 0x80000000])
def test_f32_identities_on_a_slice(first):
    """rt_f32_identities over 2^20 f32 patterns (zero and the subnormals,
    [0.5, 0.5 + 2^-4), the top binades and inf/NaN, -0 on): no fault."""
    _need_cuda()
    ids = _kernels.f32_identities(first, 2**20)
    finite = sum(1 for b in (first, first + 2**20 - 1)
                 if b & 0x7F800000 != 0x7F800000)
    assert ids["patterns"] == 2**20 and ids["doubles"] <= 9 * 2**20
    assert ids["doubles"] > (8 * 2**20 if finite == 2 else 0)
    assert not (ids["sqrt_differs"] or ids["round_differs"]
                or ids["narrow_differs"])
    if first == 0x3F000000:
        assert ids["accepted"] == ids["doubles"]


def test_f32_identities_needs_a_card():
    with pytest.raises(ValueError, match="CUDA device"):
        _kernels.f32_identities(device="cpu")
    with pytest.raises(ValueError):
        _kernels.f32_identities(first=2**32, device="cuda")


# ------------- the mesh casts' glue and the composite (csrc/glue.cu)

def _glue_calls(bad):
    """One call of each glue wrapper on meta tensors, with ``bad`` applied
    to one input of the wrapper it names (see the test below)."""
    R, C, f32 = 256, 100, torch.float32
    meta = lambda *shape, dt=f32: torch.empty(shape, dtype=dt,
                                              device="meta")
    v3 = lambda: Vec3(*(meta(R) for _ in range(3)))
    O, u, cap, act = v3(), v3(), meta(R), meta(R, dt=torch.bool)
    keys = meta(R, dt=torch.int32)
    shift, layout = 8, "live"
    members, subg = (meta(40, 8), meta(40, dt=torch.int32)), 4
    outs = (meta(C), meta(C, dt=torch.int32))
    steps = [(meta(R, dt=torch.bool), meta(3, R), meta(3, R))] * 3
    if bad == "ray_rows dtype":
        O = Vec3(O.x.double(), O.y, O.z)
    elif bad == "ray_rows layout":
        layout = "tiled"
    elif bad == "ray_rows pallas extras":
        layout = "pallas"
    elif bad == "ray_rows contiguity":
        cap = torch.empty(2 * R, device="meta")[::2]
    elif bad == "ray_rows active dtype":
        act = meta(R)
    elif bad == "compact_bits C":
        C = R + 1
    elif bad == "compact_bits shift":
        shift = 7  # 256 lanes need 8 bits
    elif bad == "compact_bits keys":
        keys = meta(R, dt=torch.int64)
    elif bad == "compact_bits subgroup":
        subg = 3  # does not divide C
    elif bad == "compact_bits member tiles":
        members = (members[0], meta(40))
    elif bad == "scatter shape":
        outs = (meta(C + 1),)
    elif bad == "scatter dtype":
        outs = (meta(C, dt=torch.float64),)
    elif bad == "scatter count":
        outs = outs * 3
    elif bad == "scatter C":
        C = -1
    elif bad == "composite depth":
        steps = []
    elif bad == "composite albedo":
        steps = steps[:2] + [(steps[0][0], meta(3, R), meta(R, 3))]
    elif bad == "composite mask":
        steps = [(meta(R), meta(3, R), meta(3, R))]
    kernel = bad.split()[0]
    if kernel == "ray_rows":
        return lambda: _kernels.ray_rows(O, u, cap, act, layout)
    if kernel == "compact_bits":
        return lambda: _kernels.compact_bits(keys, C, shift, O, u, 33, subg,
                                             members, cap, act)
    if kernel == "scatter":
        return lambda: _kernels.scatter(keys, C, shift, outs,
                                        (0.0, 0) * (len(outs) // 2)
                                        + (0.0,) * (len(outs) % 2))
    return lambda: _kernels.composite(steps)


@pytest.mark.parametrize("bad,why", [
    ("ray_rows dtype", "O.x: need a contiguous"),
    ("ray_rows layout", "unknown ray-row layout"),
    ("ray_rows pallas extras", "no cap or active"),
    ("ray_rows contiguity", "cap: need a contiguous"),
    ("ray_rows active dtype", "active: need a contiguous"),
    ("compact_bits C", "0 <= C <= Rp"),
    ("compact_bits shift", "Rp <= 2\\^shift"),
    ("compact_bits keys", "keys: need a contiguous"),
    ("compact_bits subgroup", "subgroup 3 does not divide"),
    ("compact_bits member tiles", "member_tile: need a contiguous"),
    ("scatter shape", r"outs\[0\]: need a contiguous \(100,\)"),
    ("scatter dtype", "float32 or int32"),
    ("scatter count", "1 to 5 outputs"),
    ("scatter C", "0 <= C <= Rp"),
    ("composite depth", "at least one depth step"),
    ("composite albedo", r"alb\[2\]: need a contiguous \(3, 256\)"),
    ("composite mask", r"is_diff\[0\]: need a contiguous"),
    ("ray_rows device", "one CUDA device"),
    ("compact_bits device", "one CUDA device"),
    ("scatter device", "one CUDA device"),
    ("composite device", "one CUDA device")])
def test_glue_wrappers_check_their_inputs(bad, why):
    """The glue wrappers (and compact_bits, a compacted cast's rows with
    their culling) refuse a wrong dtype, shape, contiguity, layout, width
    C past the cast, a key shift that does not hold its lanes, a subgroup
    that does not divide C, member tiles not int32, and a composite of no
    depth, before anything is built or launched; well-formed tensors that
    are not on a CUDA device (here meta tensors) are refused last."""
    assert set(_kernels.GLUE) | {"compact_bits"} <= set(_kernels.LAUNCHES)
    before = dict(_kernels.LAUNCHES)
    with pytest.raises(ValueError, match=why):
        _glue_calls(bad)()
    assert _kernels.LAUNCHES == before


GLUE_FRAMES = {
    "array_bvh pairs, ladder at every depth": ("array_bvh", dict(
        pairs_compact_min_depth=0, pairs_block=1024)),
    "array_bvh pairs, one tier of 2%": ("array_bvh", dict(
        pairs_compact_min_depth=0, pairs_block=1024, pairs_compact=0.02,
        pairs_compact2=0.0, pairs_compact3=0.0)),
    "array_bvh pallas": ("array_bvh", dict(traversal="pallas")),
    "realtime": ("realtime", {}), "showcase": ("showcase", {})}


@pytest.mark.cuda
@pytest.mark.parametrize("frame", list(GLUE_FRAMES))
def test_glue_kernels_bitwise_equal_plain(frame):
    """On the calls of a 64x64 spp4 d3 frame (each cast of the first
    trace's depths 0-2, its composite) each kernel of csrc/glue.cu equals
    its plain version bit for bit; the frame equals the frame with the
    plain glue patched in, which launches none of them; each cast builds
    its rows once (full width, or compacted and scattered back), each
    trace composes once."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    name, kw = GLUE_FRAMES[frame]
    cfg, tables = build_preset(name, "cuda", width=64, height=64, spp=4,
                               max_depth=3, **kw)
    _kernels.reset_launches()
    kept, (img, st) = cg.capture(lambda: render_preset_frame(tables, cfg, 0))
    got = {k: _kernels.LAUNCHES[k] for k in (*_kernels.GLUE, "compact_bits")}
    casts = sum(_kernels.LAUNCHES[k] for k in (*_kernels._SPECS,))
    assert got["ray_rows"] + got["compact_bits"] == casts
    assert got["scatter"] == got["compact_bits"]
    assert got["composite"] == _kernels.LAUNCHES["shade"] // 3
    assert all(r[-1] for r in cg.hold(kept, frame, {}, quiet=True))
    with cg.plain_glue():
        _kernels.reset_launches()
        img_p, st_p = render_preset_frame(tables, cfg, 0)
    assert not any(_kernels.LAUNCHES[k] for k in (*_kernels.GLUE,
                                                   "compact_bits"))
    np.testing.assert_array_equal(img, img_p)
    for a, b in zip(st, st_p):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_glue_kernels_bitwise_on_hard_lanes(seed):
    """bench/cast_glue.adversarial_calls: NaN, infinite, huge, zero, -0.0
    and denormal rays in every layout, compacted widths 0 to Rp, scatters
    of random bits, composites past one launch's depths; one launch a
    composite of up to COMPOSITE_DEPTHS depths."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import cast_glue as cg

    calls = cg.adversarial_calls(torch.device("cuda"), R=65536, seed=seed)
    assert cg.hold_calls(calls, f"seed {seed}", {}, quiet=True)
    steps = next(a for k, _, _, a in calls if k == "composite"
                 and len(a[0]) == 17)
    n0 = _kernels.LAUNCHES["composite"]
    cg.call("composite", steps, plain=False)
    assert _kernels.LAUNCHES["composite"] == n0 + 3
