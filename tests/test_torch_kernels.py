"""The port's hand-written CUDA kernels and their wrappers
(raytracinggpu_tpu_torch/ops/_kernels.py, the ops/pairs_trace.py and
ops/pallas_trace.py dispatch).

This file imports neither jax nor the JAX package, so it also runs on a
machine that has only the port's dependencies:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

The cases marked ``cuda`` need a CUDA device and nvcc; they build the
kernels and hold each one (B0-B3, B5, B6) bit for bit against its plain
PyTorch version (the kernels are compiled with --fmad=false, so every
product and sum rounds as PyTorch's eager ops round it).  Without a device
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
                                      "pallas_shadow"}
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


# ------------------------------------------------------------ CUDA cases

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


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
    assert _kernels.LAUNCHES == {"pairs_closest": 2, "pairs_shadow": 2,
                                 "pairs_closest_smooth": 0,
                                 "pairs_closest_idx": 0, "pallas_closest": 0,
                                 "pallas_shadow": 0}
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
    assert _kernels.LAUNCHES == {"pairs_closest": 0, "pairs_shadow": 0,
                                 "pairs_closest_smooth": 0,
                                 "pairs_closest_idx": 0, "pallas_closest": 2,
                                 "pallas_shadow": 2}
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
