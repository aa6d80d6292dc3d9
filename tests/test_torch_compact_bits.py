"""A compacted pairs cast's rows and culling in one call (ops/pairs_trace.py
``compact_bits``; the kernel ``rt_compact_bits`` of csrc/cull.cu).

- ``compact_bits_plain`` is ``compact_rows_plain`` followed by
  ``pair_bits_plain`` on the rows it gathered, bit for bit, and the
  dispatching ``compact_bits`` runs it on CPU tensors: the closest cast's
  layout (cap) and the shadow cast's (cap and the mask), cap on and off,
  tiers of 40,960 and 69,632 rays, the keys' shifts of key modes 1 and 2,
  subgroups 16 and 64;
- against the JAX package: ``jnp.take`` of its live rows
  (``_ray_feature_rows(..., pad=False)``) at the same source lanes, then
  its ``_pair_bits`` with members on the rows it took.  The culling words
  and the copied rows (u, O, cap, the mask) are bitwise; ``w = O x u``
  within 1 ulp on every lane and bitwise on at least 99.99% of them
  (XLA:CPU fuses a multiply-add that ``core/vec.fma`` rounds in f64;
  tests/test_torch_cast_glue.py);
- ``cuda`` cases (skipped without a card): the kernel bitwise the plain
  version on the same calls, at every rays-a-thread it takes, one launch a
  call, and on ``bench/cast_glue.adversarial_calls``' compacted calls.

The rays are seeded with numpy: origins in the cat's box and around it,
directions on the sphere, caps and a mask; the keys are a permutation of
the lanes sorted under random groups, as the ladder's sort leaves them.
No test here imports a JAX bench module (ROADMAP C3).  The card's machine
has no JAX: this file imports it only where it is installed, and there
runs its ``cuda`` cases alone (``-m cuda``).
"""
import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH

try:
    import jax
    import jax.numpy as jnp
    from raytracinggpu_tpu.core.vec import Vec3 as JV
    from raytracinggpu_tpu.ops import pairs_trace as jpt
except ImportError:  # the card's machine: the cuda cases only
    jax = jnp = JV = jpt = None

torch.set_num_threads(2)

RP = 81920            # the cast's rays, padded
TIERS = (40960, 69632)
# the keys' shift at the cat's 40 tiles: key mode 2 (first * 41 + last)
# and key mode 1 (first), as ops/pairs_trace._key_mode sets them
SHIFTS = {2: 31 - (41 * 41 - 1).bit_length(), 1: 31 - (40).bit_length()}
LAYOUTS = {"closest": (True, False), "shadow": (True, True)}


@pytest.fixture(scope="module")
def cat():
    """The cat's pairs tables (port and JAX package: the same bits,
    tests/test_torch_scene.py), and the mesh for them."""
    mesh = load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))
    return mesh, ppt.build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh,
                                        "cpu")


def _rays(seed=3):
    """(O (3, RP), u (3, RP), cap (RP,), active (RP,)) as numpy: half the
    origins in the cat's box, half around it; the last 512 lanes the
    padding's (O = 0, u = 1, cap = 0, inactive)."""
    rng = np.random.default_rng(seed)
    O = rng.uniform(-8.0, 8.0, (3, RP)).astype(np.float32)
    O[1] -= 8.0
    far = rng.random(RP) < 0.5
    O[:, far] = rng.uniform(-25.0, 25.0, (3, int(far.sum()))).astype(
        np.float32)
    d = rng.normal(size=(3, RP)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cap = rng.uniform(0.0, 40.0, RP).astype(np.float32)
    act = rng.random(RP) < 0.6
    O[:, -512:], d[:, -512:], cap[-512:], act[-512:] = 0.0, 1.0, 0.0, False
    return O, d, cap, act


def _keys(shift, seed=5):
    """Sorted keys of RP lanes: (group << shift) | lane, random groups."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 1 << (31 - shift), RP).astype(np.int64)
    return np.sort((groups << shift) | np.arange(RP)).astype(np.int32)


def _args(tab, layout, with_cap, C, mode, subg, device="cpu"):
    """compact_bits' arguments on ``device``."""
    O, d, cap, act = _rays()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    has_cap, has_active = LAYOUTS[layout]
    shift = SHIFTS[mode]
    members = (tab.member_aabb.to(device), tab.member_tile.to(device))
    return (t(_keys(shift)), C, shift, PV(*map(t, O)), PV(*map(t, d)),
            tab.tile_aabb.shape[0], subg, members,
            t(cap) if has_cap and with_cap else None,
            t(act) if has_active else None)


CASES = [(layout, with_cap, C, mode, subg)
         for layout in LAYOUTS for with_cap in (True, False)
         for C in TIERS for mode in (2, 1) for subg in (64, 16)
         if (C, mode) != (TIERS[1], 1) or subg == 64]


@pytest.mark.parametrize("layout,with_cap,C,mode,subg", CASES)
def test_compact_bits_plain_is_compact_rows_then_pair_bits(
        cat, layout, with_cap, C, mode, subg):
    _, tab = cat
    args = _args(tab, layout, with_cap, C, mode, subg)
    keys, C, shift, O, u, nc, subg, members, cap, act = args
    rows, src, act_c = ppt.compact_rows_plain(keys, C, shift, O, u, cap, act)
    bits = ppt.pair_bits_plain(PV(rows[6], rows[7], rows[8]),
                               PV(rows[0], rows[1], rows[2]), nc, subg,
                               members, None if cap is None else rows[9],
                               act_c)
    for got in (ppt.compact_bits_plain(*args), ppt.compact_bits(*args)):
        g_rows, g_act, g_bits = got
        assert torch.equal(g_rows.view(torch.int32), rows.view(torch.int32))
        assert (g_act is None) == (act_c is None)
        assert g_act is None or torch.equal(g_act, act_c)
        assert g_bits.dtype == torch.int32 and torch.equal(g_bits, bits)
    assert rows.shape == (9 + (2 if act is not None else int(
        cap is not None)), C)
    assert bits.shape == (2, C // subg) and int((bits != 0).sum()) > 0


def test_cpu_compact_bits_leave_the_launch_counts_untouched(cat):
    _, tab = cat
    before = dict(_kernels.LAUNCHES)
    ppt.compact_bits(*_args(tab, "shadow", True, TIERS[0], 2, 64))
    assert _kernels.LAUNCHES == before


def _ulps(a, b):
    def line(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(line(a) - line(b))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


@pytest.mark.parametrize("layout,with_cap,C,mode", [
    ("closest", True, 40960, 2), ("closest", False, 69632, 1),
    ("shadow", True, 69632, 2), ("shadow", False, 40960, 1)])
def test_compact_bits_match_jax_take_then_pair_bits(cat, layout, with_cap,
                                                    C, mode):
    if jpt is None:
        pytest.skip("needs the JAX package's JAX")
    _, tab = cat
    subg = 64
    args = _args(tab, layout, with_cap, C, mode, subg)
    keys, C, shift, O, u, nc, subg, (boxes, tiles), cap, act = args
    j = lambda x: None if x is None else jnp.asarray(x.numpy())
    extras = ()
    if act is not None:
        extras = (j(cap) if cap is not None
                  else jnp.zeros(RP, jnp.float32), j(act).astype(jnp.float32))
    elif cap is not None:
        extras = (j(cap),)
    src = j(keys[:C] & ((1 << shift) - 1))
    # jitted, as the JAX package's trace runs it (XLA:CPU fuses the
    # cross product's multiply-add then)
    jrows = jax.jit(lambda O, u, e, src: jnp.take(
        jpt._ray_feature_rows(O, u, e, pad=False), src, axis=1))(
            JV(*map(j, O)), JV(*map(j, u)), extras, src)
    jbits = jpt._pair_bits(
        JV(jrows[6], jrows[7], jrows[8]), JV(jrows[0], jrows[1], jrows[2]),
        j(tab.tile_aabb), nc, subg, 4096,
        cap=None if cap is None else jrows[9],
        active=None if act is None else jrows[10] > 0.5,
        members=(j(boxes), j(tiles)))
    rows, act_c, bits = ppt.compact_bits(*args)
    want, got = np.asarray(jrows), rows.numpy()
    assert got.shape == want.shape
    for r in range(got.shape[0]):
        d = _ulps(got[r], want[r])
        if r in (3, 4, 5):  # w = O x u
            assert d.max() <= 1 and (d == 0).mean() >= 0.9999, r
        else:
            assert (d == 0).all(), r
    if act is not None:
        np.testing.assert_array_equal(act_c.numpy(), want[10] > 0.5)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))


# ------------------------------------------------------------ CUDA cases

def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _same(got, want):
    rows, act, bits = got
    w_rows, w_act, w_bits = want
    return (torch.equal(rows.view(torch.int32), w_rows.view(torch.int32))
            and (act is None) == (w_act is None)
            and (act is None or torch.equal(act, w_act))
            and torch.equal(bits, w_bits))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,with_cap,C,mode,subg", CASES)
def test_compact_bits_kernel_bitwise_equals_plain(cat, layout, with_cap, C,
                                                  mode, subg):
    """rt_compact_bits on the card, through the wrapper (one launch) and
    at one and two rays a thread forced, bitwise compact_bits_plain."""
    _need_cuda()
    _, tab = cat
    args = _args(tab, layout, with_cap, C, mode, subg, "cuda")
    want = ppt.compact_bits_plain(*args)
    n0 = _kernels.LAUNCHES["compact_bits"]
    got = ppt.compact_bits(*args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["compact_bits"] == n0 + 1
    assert _same(got, want)
    from raytracinggpu_tpu_torch.bench.compact_bits_design import (
        _outputs, fused)

    lib = _kernels.load()
    for k in (1, 2):
        out = fused(lib, args, _outputs(args), k)
        torch.cuda.synchronize()
        assert _same(out, want), k


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_compact_bits_kernel_bitwise_on_hard_lanes(seed):
    """bench/cast_glue.adversarial_calls' compacted calls (C = 0 to Rp,
    subgroups 1, 16, 64; NaN, infinite, huge, zero, -0.0 and denormal
    rays, origins on box faces and corners, flat, point and inverted
    boxes)."""
    _need_cuda()
    from raytracinggpu_tpu_torch.bench import cast_glue as cg

    calls = [c for c in cg.adversarial_calls(torch.device("cuda"), seed=seed)
             if c[0] == "compact_bits"]
    assert len(calls) == 20
    assert cg.hold_calls(calls, f"seed {seed}", {}, quiet=True)
