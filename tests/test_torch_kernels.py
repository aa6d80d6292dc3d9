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
                                      "pallas_shadow", *_kernels.PROBES}
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

def _tiled_cast(scene, kind, R, device, seed=0, capped=True):
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
    rfT, lists, _, _ = pat.cast_inputs(O, u, tab, SUBG, cap=cap)
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
    assert _launched() == {"pairs_closest": 2, "pairs_shadow": 2}
    (img_c, st_c), (img_g, st_g) = frames
    assert np.isfinite(img_g).all()
    assert st_g.hit.tolist() == [48 * 48 * 2] * 2
    bad = np.abs(img_g - img_c) > 1e-4 * np.abs(img_c) + 1.0
    assert bad.any(-1).mean() < 0.005


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [True, False])
@pytest.mark.parametrize("kind", KINDS)
def test_tiled_kernels_bitwise_equal_plain(scene, kind, capped):
    """B5 and B6 against their plain versions on the same lists; the public
    queries launch them for CUDA tensors, sorted or not."""
    _need_cuda()
    tab, O, u, cap, rfT, lists = _tiled_cast(scene, kind, 8192, "cuda",
                                             capped=capped)
    args = (rfT, tab.fields, lists, EPS, SUBG)
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
                                        cap=cap, subg=SUBG)
        t = pat.intersect_tris_shadow(O, u, tab, EPS, cap=cap,
                                      sort_rays=sort, subg=SUBG)
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


@pytest.mark.cuda
def test_tiled_kernels_break_ties_and_skip_bad_ids():
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


@pytest.mark.cuda
def test_small_pallas_frame_on_cuda_matches_cpu():
    """The 48x48 spp2 d2 frame through the tiled traversal: one 5120-ray
    cast per depth (4608 rays and 512 zero-direction padding rays), B5 and
    B6 once each per cast; the bound of test_small_frame_on_cuda_matches_cpu
    against the CPU frame."""
    _need_cuda()
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame

    size = dict(width=48, height=48, spp=2, max_depth=2, traversal="pallas")
    frames = []
    for dev in ("cpu", "cuda"):
        cfg, tables = build_preset("array_bvh", dev, **size)
        _kernels.reset_launches()
        frames.append(render_preset_frame(tables, cfg, seed=0))
    assert _launched() == {"pallas_closest": 2, "pallas_shadow": 2}
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
def test_probe_block_mask_and_row_gather_are_exact():
    _need_cuda()
    mk, rf, _ = _probe_cast()
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
