"""The port's probe plain versions against the JAX package's probe
arithmetic (raytracinggpu_tpu_torch/bench/micro_kernel.py against
raytracinggpu_tpu/bench/micro_kernel.py).

The JAX probes exist only inside timed ``pl.pallas_call``s and discard
their outputs, so the reference here is the JAX ``_mt_pass`` itself, run
inside a ``pl.pallas_call(..., interpret=True)`` written around it; each
probe's contract (the per-ray min over the visited tiles, 1e9 on a miss)
is then taken over those passes with numpy.  The JAX module points JAX's
persistent compilation cache at a directory of its own when it is
imported, which would leak into whatever else this process tests, so the
JAX side runs once in a process of its own (``JAX_SIDE`` below, the cache
switched off) on the seeded inputs this file hands it.

Tolerance: XLA:CPU contracts the pass's multiply-adds into FMAs while the
port rounds every product (to match its CUDA kernels bit for bit), so
hit/miss must be identical on every lane and |dt| <= 1e-6 * max(|t|, 1).
The error is absolute where t is small: t = (A.Ng - O.Ng) / (u.Ng), and
with these all-positive inputs only the numerator cancels, so a short t
carries the rounding of O(1) operands (measured over every ray and tile
here: relative 4.0e-5 on a t of 2e-3, absolute 7.8e-8).  The same form as
the per-cast standard of tests/test_torch_pairs.py.  B7b and B7d have no
rounding: exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.bench import micro_kernel as mk
from raytracinggpu_tpu_torch.ops import _kernels

torch.set_num_threads(2)

R, N_TILES = 2048, 9
TOL = 1e-6
SINGLE = ((0, 0), (3, 5), (31, 8))  # (subgroup, tile) of the single passes
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: the .npz of rf (R, 16) and tri (16, n * 128), the output .npz.
# Writes "all": the JAX _mt_pass of every ray over every tile (n, R, 128),
# one grid step a tile; "single": one (64, 128) pass per SINGLE entry.
JAX_SIDE = """
import sys
import jax, numpy as np
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from jax.experimental import pallas as pl
from raytracinggpu_tpu.bench.micro_kernel import _mt_pass

d = np.load(sys.argv[1])
rf, tri = jnp.asarray(d["rf"]), jnp.asarray(d["tri"])
R, n = rf.shape[0], tri.shape[1] // 128

def every_tile(rf_ref, tri_ref, o_ref):
    off = pl.multiple_of(pl.program_id(0) * 128, 128)
    o_ref[0] = _mt_pass(rf_ref, tri_ref, pl.ds(0, R), off)

passes = pl.pallas_call(
    every_tile, grid=(n,),
    in_specs=[pl.BlockSpec((R, 16), lambda i: (0, 0)),
              pl.BlockSpec((16, n * 128), lambda i: (0, 0))],
    out_specs=pl.BlockSpec((1, R, 128), lambda i: (i, 0, 0)),
    out_shape=jax.ShapeDtypeStruct((n, R, 128), jnp.float32),
    interpret=True)(rf, tri)

def single(sg, tile):
    def kernel(rf_ref, tri_ref, o_ref):
        o_ref[:] = _mt_pass(rf_ref, tri_ref, pl.ds(sg * 64, 64), tile * 128)
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((64, 128), jnp.float32),
        interpret=True)(rf, tri)

np.savez(sys.argv[2], all=np.asarray(passes), single=np.stack(
    [np.asarray(single(sg, tile)) for sg, tile in %r]))
""" % (SINGLE,)


@pytest.fixture(scope="module")
def cast(tmp_path_factory):
    """Seeded (rf, tri) as torch tensors, the JAX pass of every ray over
    every tile, (N_TILES, R, 128), and the JAX single passes."""
    rf, tri = mk.cast_inputs(R, N_TILES, 0, "cpu")
    d = tmp_path_factory.mktemp("jax_side")
    np.savez(d / "in.npz", rf=rf.numpy(), tri=tri.numpy())
    env = dict(os.environ, JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR="",
               PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", JAX_SIDE, str(d / "in.npz"),
         str(d / "out.npz")], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = np.load(d / "out.npz")
    return rf, tri, got["all"], got["single"]


def _close(got, want):
    """Hit/miss identical, |dt| <= TOL * max(|t|, 1)."""
    got = got.numpy().reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    np.testing.assert_array_equal(got == mk.MISS, want == mk.MISS)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _min_rows(passes, rows, tiles):
    """numpy: min over ``tiles`` of the JAX passes of rays ``rows``."""
    t = np.full(len(rows), mk.MISS, np.float32)
    for j in tiles:
        t = np.minimum(t, passes[j][rows].min(axis=1))
    return t


@pytest.mark.parametrize("k", range(len(SINGLE)))
def test_mt_pass_matches_the_jax_pass(cast, k):
    """One (64, 128) pass, as the probes' kernels run it a visit."""
    rf, tri, every, single = cast
    (sg, tile), want = SINGLE[k], single[k]
    np.testing.assert_array_equal(want,
                                  every[tile][sg * 64:sg * 64 + 64])
    got = mk._mt_pass(rf, tri, slice(sg * 64, sg * 64 + 64), tile * 128)
    assert got.shape == (64, 128) and got.dtype == torch.float32
    _close(got, want)
    hits = (want < mk.MISS).sum()
    assert 0 < hits < want.size  # the seeded triangles are hit and missed
    assert (got.numpy() == want).mean() > 0.9


@pytest.mark.parametrize("L", [0, 1, 2, 4, 8])
def test_tile_slope_plain(cast, L):
    rf, tri, passes, _ = cast
    got = mk.tile_slope_plain(mk.tile_lists(R, L, "cpu"), rf, tri)
    assert got.shape == (R // 128, 128)
    _close(got, _min_rows(passes, np.arange(R), range(L)))
    if L == 0:
        assert (got == mk.MISS).all()
    else:
        assert (got < mk.MISS).any()


def test_tile_slope_plain_reads_count_ids_only(cast):
    """Ids past the count, and ids outside the table, are not visited."""
    rf, tri, passes, _ = cast
    lists = mk.tile_lists(R, 0, "cpu")
    lists[:, 0] = 3
    lists[:, 1:5] = torch.tensor([7, -1, 2, 5], dtype=torch.int32)
    lists[1, 0] = 500  # cut at the row's width
    lists[1, 1:] = N_TILES  # no such tile
    got = mk.tile_slope_plain(lists, rf, tri).reshape(-1)
    want = _min_rows(passes, np.arange(R), (7, 2))
    want[64:128] = mk.MISS
    _close(got, want)


@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_uniform_branch_plain(cast, frac):
    rf, tri, passes, _ = cast
    m = (np.random.default_rng(3).random((R // 64, 128)) < frac)
    got = mk.uniform_branch_plain(torch.from_numpy(m.astype(np.int32)), rf,
                                  tri).reshape(-1)
    want = np.concatenate([
        _min_rows(passes, np.arange(sg * 64, sg * 64 + 64),
                  np.flatnonzero(m[sg, :mk.N_FIXED]))
        for sg in range(R // 64)])
    _close(got, want)
    if frac == 1.0:  # the unconditional loop of B7a at L = 8
        assert torch.equal(got.reshape(R // 128, 128), mk.tile_slope_plain(
            mk.tile_lists(R, 8, "cpu"), rf, tri))


@pytest.mark.parametrize("L", [0, 1, 2, 4])
@pytest.mark.parametrize("subg", [8, 16, 32, 64])
def test_pair_slope_plain(cast, subg, L):
    rf, tri, passes, _ = cast
    pairs = mk.pair_lists(R, N_TILES, subg, L, "cpu")
    n_sg = 1024 // subg
    assert pairs.shape[0] == R // 1024 and int(pairs[0, 0]) == n_sg * L
    got = mk.pair_slope_plain(pairs, rf, tri, subg).reshape(-1)
    want = np.full(R, mk.MISS, np.float32)
    for b in range(R // 1024):
        for p in pairs[b, 1:1 + int(pairs[b, 0])].tolist():
            rows = b * 1024 + (p >> 8) * subg + np.arange(subg)
            want[rows] = np.minimum(want[rows],
                                    _min_rows(passes, rows, [p & 255]))
    _close(got, want)
    assert bool((got == mk.MISS).all()) == (L == 0)


def test_pair_slope_plain_skips_bad_pairs(cast):
    rf, tri, _, _ = cast
    good = mk.pair_lists(R, N_TILES, 64, 2, "cpu")
    n = int(good[0, 0])
    bad = torch.zeros((R // 1024, n + 4), dtype=torch.int32)
    bad[:, 0] = n + 3
    bad[:, 1:1 + n] = good[:, 1:1 + n]
    bad[:, 1 + n:] = torch.tensor([16 * 256, 200, -5], dtype=torch.int32)
    assert torch.equal(mk.pair_slope_plain(bad, rf, tri, 64),
                       mk.pair_slope_plain(good, rf, tri, 64))


def test_block_mask_and_row_gather_are_exact():
    rng = np.random.default_rng(5)
    x = rng.random((2048, 16), dtype=np.float32)
    for mask in (True, False):
        np.testing.assert_array_equal(
            mk.block_mask_plain(torch.from_numpy(x), mask).numpy(),
            x * np.float32(2.0))
    table = rng.random((mk.GATHER_ROWS, 128), dtype=np.float32)
    idx = rng.integers(0, mk.GATHER_ROWS, (2048, 1)).astype(np.int32)
    np.testing.assert_array_equal(
        mk.row_gather_plain(torch.from_numpy(idx),
                            torch.from_numpy(table)).numpy(),
        table[idx[:, 0]])


def test_cpu_tensors_run_the_plain_versions(cast):
    rf, tri, _, _ = cast
    before = dict(_kernels.LAUNCHES)
    lists = mk.tile_lists(R, 2, "cpu")
    assert torch.equal(mk.tile_slope(lists, rf, tri),
                       mk.tile_slope_plain(lists, rf, tri))
    pairs = mk.pair_lists(R, N_TILES, 16, 1, "cpu")
    assert torch.equal(mk.pair_slope(pairs, rf, tri, 16),
                       mk.pair_slope_plain(pairs, rf, tri, 16))
    x = rf.clone()
    assert torch.equal(mk.block_mask(x), x * 2.0)
    assert _kernels.LAUNCHES == before  # nothing was launched
    with pytest.raises(ValueError):
        mk.block_mask(torch.empty(1024, 16, device="meta"))


def test_main_on_cpu_runs_the_named_probes(capsys):
    res = mk.main(["--rays", "1024", "--iters", "1", "--device", "cpu",
                   "--only", "slope,dma,gather"])
    assert list(res) == ["slope", "dma", "gather"]
    assert [c["L"] for c in res["slope"]] == [0, 1, 2, 4, 8]
    assert res["slope"][4]["tests"] == (1024 // 64) * 8 * 64 * 128
    assert (res["slope"][0]["out"] == mk.MISS).all()
    assert res["dma"]["nbytes"] == 2 * 1024 * 64
    assert res["gather"]["out"].shape == (1024, 128)
    out = capsys.readouterr().out
    assert "tile_slope L=8" in out and "dma_smem: with=" in out
    assert "pair_slope" not in out
    with pytest.raises(SystemExit):
        mk.main(["--only", "nosuch", "--device", "cpu"])
    with pytest.raises(ValueError, match="multiple of 1024"):
        mk.main(["--rays", "1000", "--device", "cpu"])


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mk.main(["--rays", "1024"])


def test_timed_on_the_cpu_counts_every_call():
    from raytracinggpu_tpu_torch.bench._timing import timed

    calls = []
    dt = timed(lambda: calls.append(1), iters=5, warm=2, device="cpu")
    assert len(calls) == 7 and dt >= 0.0
