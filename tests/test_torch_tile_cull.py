"""The tiled traversal's culling in the port against the JAX package's:
``block_active_tiles_plain`` of raytracinggpu_tpu_torch/ops/pallas_trace.py
and the dispatching ``_block_active_tiles`` on CPU tensors, bitwise
raytracinggpu_tpu/ops/pallas_trace.py's ``_block_active_tiles`` on the CPU
(its int8 / int16 rows as int32).

The slab test has no multiply-add, so the two packages agree bit for
bit: each row's count, its active tile ids ascending and its inactive ids
ascending.  The inputs are made with numpy from a seed:

- bench/cull.py's ``adversarial_tiles`` tables: direction components of
  exactly +0.0 and -0.0, origins on box faces and corners, boxes of zero
  thickness, inverted boxes, the padding tiles' inverted (+INF, -INF)
  box, NaN in lo.x, in hi.x and in another coordinate, a box of infinite
  extent, caps at exactly an enter distance; at subgroups 1, 4, 16, 64
  and 128 and 4, 31, 32, 33, 126, 127 and 300 tiles (across the 32-tile
  words of the kernel's bitmask and the JAX package's int8 / int16 switch
  at 126), with and without cap;
- the cat's tiled tables through ``convert.scene_tables_from_numpy`` (the
  same tables in both packages) and camera and scattered rays.

The CUDA kernel of csrc/cull.cu (``rt_tile_lists``) is held bitwise
against the plain version in tests/test_torch_kernels.py, and here, in
``cuda`` cases (skipped without a card), in its one launch and in its two
(the words through device memory, then the rows) on the adversarial
tables at subgroups 1-128, with the words in more than one pass (5,000
tiles) and past 131,072 tiles.  The card's machine has no JAX: this file
imports it only where it is installed, and there runs its ``cuda`` cases
alone (``-m cuda``).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp
    from raytracinggpu_tpu.core.vec import Vec3 as JV
    from raytracinggpu_tpu.ops import pallas_trace as jpt
    from raytracinggpu_tpu.scene.presets import (
        build_preset as j_build_preset)
except ImportError:  # the card's machine: the cuda cases only
    jax = jnp = JV = jpt = j_build_preset = None
from raytracinggpu_tpu_torch.bench.cull import adversarial_tiles, enter_of
from raytracinggpu_tpu_torch.convert import scene_tables_from_numpy
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pallas_trace as ppt

torch.set_num_threads(2)

R = 2048
TILE_COUNTS = [4, 31, 32, 33, 126, 127, 300]
SUBGROUPS = [1, 4, 16, 64, 128]


def _j(a):
    return JV(*(jnp.asarray(c) for c in a))


def _p(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _lists(O, u, aabb, n_tiles, subg, cap):
    """(JAX rows as int32, port plain rows, port dispatched rows), numpy."""
    want = np.asarray(jpt._block_active_tiles(
        _j(O), _j(u), jnp.asarray(aabb), n_tiles,
        cap=None if cap is None else jnp.asarray(cap), subg=subg))
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    plain = ppt.block_active_tiles_plain(_p(O), _p(u), t(aabb), n_tiles,
                                         cap=t(cap), subg=subg)
    disp = ppt._block_active_tiles(_p(O), _p(u), t(aabb), n_tiles,
                                   cap=t(cap), subg=subg)
    assert plain.dtype == disp.dtype == torch.int32
    assert want.dtype == (np.int8 if n_tiles <= 126 else np.int16)
    return want.astype(np.int32), plain.numpy(), disp.numpy()


def _check_rows(rows, aabb, n_tiles):
    """Each row: a count, then a permutation of the tiles, the active ones
    ascending, then the rest ascending; no invalid box is active."""
    valid = aabb[:n_tiles, 0] <= aabb[:n_tiles, 3]
    for row in rows:
        n, ids = int(row[0]), row[1:]
        assert sorted(ids.tolist()) == list(range(n_tiles))
        on, off = ids[:n], ids[n:]
        assert (np.diff(on) > 0).all() and (np.diff(off) > 0).all()
        assert valid[on].all()


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", SUBGROUPS)
@pytest.mark.parametrize("n_tiles", TILE_COUNTS)
def test_tile_lists_match_jax_on_adversarial_tables(n_tiles, subg, capped):
    O, u, aabb, cap = adversarial_tiles(7 * n_tiles + subg, R, n_tiles)
    want, plain, disp = _lists(O, u, aabb, n_tiles, subg,
                               cap if capped else None)
    assert want.shape == (R // subg, 1 + n_tiles)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(disp, want)
    _check_rows(want, aabb, n_tiles)
    # some subgroup culls some tile and keeps another
    assert (want[:, 0] < n_tiles).all() and want[:, 0].max() > 0


def test_adversarial_tile_tables_are_adversarial():
    """The tables hold what bench/cull.adversarial_tiles promises: signed
    zero directions, padding tiles' inverted boxes at the end and in the
    middle, NaN in lo.x, hi.x and another coordinate, a box of infinite
    extent, caps at some box's exact enter distance."""
    O, u, aabb, cap = adversarial_tiles(0, R, 300)
    zero = u == 0
    assert np.signbit(u[zero]).any() and (~np.signbit(u[zero])).any()
    pad = (aabb[:, 0:3] == np.float32(1e9 + 9)).all(axis=1) \
        & (aabb[:, 3:6] == -np.float32(1e9 + 9)).all(axis=1)
    assert pad[300 - 300 // 8:].all() and pad[150] \
        and pad.sum() == 300 // 8 + 1
    nan = np.isnan(aabb)
    assert nan[:, 0].sum() == nan[:, 3].sum() == 1
    assert nan[:, [1, 2, 4, 5]].sum() == 1
    assert (np.isinf(aabb[:, 0:6]) & ~pad[:, None]).all(axis=1).sum() == 1
    assert (aabb[:, 0:3] == aabb[:, 3:6]).any(axis=1).any()
    hits = 0
    for b in range(0, 300, 10):
        if pad[b] or nan[b].any():
            continue
        e = enter_of(O, u, np.repeat(aabb[b:b + 1], R, axis=0))
        hits += int((np.isfinite(cap) & (cap > 0) & (cap == e)).sum())
    assert hits > 0
    # a small table keeps its padding and no NaN box
    _, _, small, _ = adversarial_tiles(0, 64, 4)
    assert not np.isnan(small).any() and small[2, 0] > small[2, 3]


def _cat_rays(kind, n, seed):
    """(O, u) (3, n) f32: a fan from the camera or scattered rays."""
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        O = rng.uniform(-25, 25, (3, n)).astype(np.float32)
    else:
        O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, n))
    d = rng.normal(size=(3, n)).astype(np.float32)
    if kind == "camera":
        d[2] = -np.abs(d[2]) * 4.0 - 2.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return O, d.astype(np.float32)


@pytest.fixture(scope="module")
def cat():
    _, jtab = j_build_preset("array_bvh", traversal="pallas")
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jtab.pallas_mesh, ptab.pallas_mesh


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", [16, 64])
@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_tile_lists_match_jax_on_the_cat(cat, kind, subg, capped):
    """The cat's 32 tile boxes (31 of its triangles, one padding tile) on
    4,096 rays, seeded caps."""
    jtab, ptab = cat
    aabb = np.asarray(jtab.tile_aabb)
    np.testing.assert_array_equal(aabb, ptab.tile_aabb.numpy())
    n_tiles = ptab.n_tiles
    assert n_tiles == aabb.shape[0] == 32
    assert (aabb[:, 0] <= aabb[:, 3]).sum() == 31
    O, u = _cat_rays(kind, 4096, seed=subg)
    cap = np.random.default_rng(3).uniform(1.0, 80.0, 4096).astype(
        np.float32) if capped else None
    want, plain, disp = _lists(O, u, aabb, n_tiles, subg, cap)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(disp, want)
    _check_rows(want, aabb, n_tiles)
    assert want[:, 0].max() > 0 and (want[:, 0] < 31).all()


def test_cpu_tile_lists_leave_the_launch_counts_untouched():
    """On CPU tensors ``_block_active_tiles`` runs the plain version: the
    same rows, and no kernel is counted."""
    O, u, aabb, cap = adversarial_tiles(1, R, 33)
    t = torch.from_numpy
    before = dict(_kernels.LAUNCHES)
    got = ppt._block_active_tiles(_p(O), _p(u), t(aabb), 33, cap=t(cap),
                                  subg=16)
    want = ppt.block_active_tiles_plain(_p(O), _p(u), t(aabb), 33,
                                        cap=t(cap), subg=16)
    assert torch.equal(got, want)
    assert _kernels.LAUNCHES == before
    assert "tile_lists" in _kernels.CULLING
    assert set(_kernels.CULLING) <= set(_kernels.LAUNCHES)


def test_tile_lists_bound_counts_the_valid_tiles():
    """bench/cull.call_bound of a tiled culling call: 524,288 rays against
    the cat's 31 valid tiles of 32 at subgroup 64, with cap: 16.25 M slab
    tests, operations-bound at 0.0058 ms (no-FMA floor 0.0117), the rays'
    O, u and cap and the 8,192 rows of 33 ints moved once; the padding
    tile is not tested."""
    from raytracinggpu_tpu_torch.bench.cull import (
        PEAK_F32_FLOPS, SLAB_OPS, bound_ms, call_bound)

    n, nt = 524288, 32
    z = lambda *shape, dt=torch.float32: torch.zeros(shape, dtype=dt)
    O = PV(z(n), z(n), z(n))
    aabb = z(nt, 8)
    aabb[-1, 0:3], aabb[-1, 3:6] = 1e9, -1e9
    lists = z(n // 64, 1 + nt, dt=torch.int32)
    got = call_bound("tile_lists", (O, O, aabb, nt, z(n), 64), lists)
    assert got == bound_ms(n, 31, nt * 6 * 4 + 4 * n, lists.numel() * 4)
    ms, by, floor = got
    assert by == "operations"
    assert ms == pytest.approx((n * 31 * SLAB_OPS + 3 * n) / PEAK_F32_FLOPS
                               * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.0058, abs=1e-4)
    assert floor == pytest.approx(2 * ms, rel=1e-12)
    nocap = call_bound("tile_lists", (O, O, aabb, nt, None, 64), lists)
    assert nocap == bound_ms(n, 31, nt * 6 * 4, lists.numel() * 4)


def test_tile_index_cases_reach_the_kernels_branches():
    """bench/cull.index_cases' tiled cases, which tests/test_torch_kernels.py
    and chip_smoke.py run through the kernel: every subgroup the tiled
    traversal admits over an odd count of subgroups (no multiple of the
    subgroups a block holds), with and without cap, word passes (5,000
    tiles at subgroups 1 and 8), a table past 131,072 tiles; each table
    adversarial (padding and NaN boxes).  On the CPU the dispatch gives
    the plain rows, which hold a permutation of the tiles."""
    from raytracinggpu_tpu_torch.bench.cull import (
        BIG_TABLE, TILE_SUBGROUPS, index_cases)

    cases = [c for c in index_cases("cpu") if c[1] == "tile_lists"]
    assert {c[2][5] for c in cases} == set(TILE_SUBGROUPS)
    assert {(c[2][3], c[2][5]) for c in cases} >= {
        (5000, 1), (5000, 8), (BIG_TABLE, 1), (BIG_TABLE, 64)}
    assert BIG_TABLE > 4096 * 32
    assert any(c[2][4] is None for c in cases) \
        and any(c[2][4] is not None for c in cases)
    for label, _, args, plain_args in cases:
        O, _, aabb, nt, _, subg = args
        n = O.x.shape[0]
        assert args is plain_args and n % subg == 0 and (n // subg) % 2
        assert aabb.shape == (nt, 8) and torch.isnan(aabb).any()
        assert (aabb[:, 0] > aabb[:, 3]).any()
        if nt == 300:
            rows = ppt._block_active_tiles(*args)
            assert torch.equal(rows, ppt.block_active_tiles_plain(*args))
            _check_rows(rows.numpy(), aabb.numpy(), nt)


# ------------------------------------------------------------ CUDA cases

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _ko(args, k, one):
    """rt_tile_lists_ko of the package's library on a _block_active_tiles
    call: k rays a thread (0: the default), one launch where it fits (one
    1) or two (one 0); returns (rows, scratch words it needed)."""
    from raytracinggpu_tpu_torch.bench.cull_design import launch

    O, u, aabb, nt, cap, subg = args
    lib = _kernels.load()
    rows = launch(lib, "tile_lists", args, ko=(k, one))
    return rows, lib.rt_tile_lists_scratch(O.x.shape[0], subg, nt, k, one)


def _cuda_tiles(seed, n_rays, n_tiles, capped):
    O, u, aabb, cap = adversarial_tiles(seed, n_rays, n_tiles)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).cuda()
    return (PV(*map(t, O)), PV(*map(t, u)), t(aabb), t(cap) if capped
            else None)


@pytest.mark.cuda
@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("subg", [1, 2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("n_tiles", TILE_COUNTS)
def test_tile_lists_kernel_one_and_two_launches(n_tiles, subg, capped):
    """The wrapper (one launch on these tables: their words fit one pass)
    and rt_tile_lists_ko forced to two launches, at every rays-a-thread
    that divides the subgroup,
    each bitwise the plain version on the adversarial tables (padding and
    NaN boxes, a box of infinite extent); one launch a wrapper call."""
    _need_cuda()
    O, u, aabb, cap = _cuda_tiles(3 * n_tiles + subg, R, n_tiles, capped)
    args = (O, u, aabb, n_tiles, cap, subg)
    want = ppt.block_active_tiles_plain(*args)
    n0 = _kernels.LAUNCHES["tile_lists"]
    got = ppt._block_active_tiles(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["tile_lists"] == n0 + 1
    assert torch.equal(got, want)
    for k in (0, 1, 2, 4):
        if k and subg % k:
            continue
        for one in (1, 0):
            rows, scratch = _ko(args, k, one)
            torch.cuda.synchronize()
            assert torch.equal(rows, want), (k, one)
            assert (scratch == 0) == bool(one), (k, one, scratch)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles,subg,n_sub", [
    (5000, 1, 37), (5000, 2, 37), (140000, 64, 7), (140000, 1, 449)])
def test_tile_lists_kernel_past_one_pass_of_words(n_tiles, subg, n_sub):
    """Tables whose words a block cannot hold in one pass (5,000 tiles:
    157 words a subgroup, at subgroups 1 and 2 a block holds 64 or more;
    140,000 tiles: 4,375 words, rows of 140,001 ints): the two launches,
    with their scratch, bitwise the plain version, whether or not one
    launch is asked for."""
    _need_cuda()
    O, u, aabb, cap = _cuda_tiles(n_tiles + subg, subg * n_sub, n_tiles,
                                  True)
    args = (O, u, aabb, n_tiles, cap, subg)
    want = ppt.block_active_tiles_plain(*args)
    assert torch.equal(ppt._block_active_tiles(*args), want)
    for one in (1, 0):
        rows, scratch = _ko(args, 0, one)
        torch.cuda.synchronize()
        assert torch.equal(rows, want) and scratch == -(-n_tiles // 32) * (
            O.x.shape[0] // subg)


@pytest.mark.cuda
def test_tile_lists_run_the_main_paths_casts_in_one_launch():
    """The cat's pallas casts (524,288 rays, 32 tiles, subgroup 64) and
    the soup's (1,564 tiles, subgroup 16) need no scratch: one launch."""
    _need_cuda()
    lib = _kernels.load()
    assert lib.rt_tile_lists_scratch(524288, 64, 32, 0, 1) == 0
    assert lib.rt_tile_lists_scratch(524288, 16, 1564, 0, 1) == 0
    assert lib.rt_tile_lists_scratch(524288, 16, 1564, 0, 0) == 49 * 32768
