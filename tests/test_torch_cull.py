"""The pairs traversal's culling in the port against the JAX package's:
``pair_bits_plain`` and ``compact_key_plain`` of
raytracinggpu_tpu_torch/ops/pairs_trace.py, and the dispatching
``_pair_bits`` and ``_compact_key`` on CPU tensors, bitwise
raytracinggpu_tpu/ops/pairs_trace.py's ``_pair_bits`` (with ``members``)
and ``_compact_key`` on the CPU.

The slab test has no multiply-add, so the two packages agree bit for
bit: the bitmask words (bit 31 the int32 sign bit), the sort keys, the
active count and the shift.  The inputs are made with numpy from a seed:

- bench/cull.py's adversarial rays and boxes: direction components of
  exactly +0.0 and -0.0, origins on box faces and corners, boxes of zero
  thickness, inverted boxes, caps at exactly an enter distance; 1,100
  member boxes (the 512-box batches of both packages run three times) in
  300 tiles (ten words a subgroup);
- the cat's tables through ``convert.scene_tables_from_numpy`` (the same
  tables in both packages) and camera and scattered rays, padded as both
  packages pad a cast (``pad_rays``);

at subgroups 16, 32 and 64, with and without cap and active, key modes 1
(1,100 key boxes) and 2 (40 boxes, and the cat's tile boxes and their
unions of 4), and valid_n below R.  The CUDA kernels of csrc/cull.cu are
held bitwise against these plain versions in tests/test_torch_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.ops import pairs_trace as jpt
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.bench.cull import adversarial, enter_of
from raytracinggpu_tpu_torch.convert import scene_tables_from_numpy
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.ops.pallas_trace import pad_rays

torch.set_num_threads(2)

R, N_BOXES, N_TILES, BLK = 4096, 1100, 300, 4096
CAP_ACTIVE = [(False, False), (True, False), (False, True), (True, True)]


@pytest.fixture(scope="module")
def adv():
    return adversarial(0, R, N_BOXES, N_TILES)


@pytest.fixture(scope="module")
def cat():
    _, jtab = j_build_preset("array_bvh", traversal="pairs")
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jtab.pairs_mesh, ptab.pairs_mesh


def _j(a):
    return JV(*(jnp.asarray(c) for c in a))


def _p(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _both(x):
    """(JAX array, torch tensor) of a numpy array, or (None, None)."""
    if x is None:
        return None, None
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def _bits_pair(O, u, boxes, tiles, nc, subg, cap, active):
    """(JAX bits, port plain bits, port dispatched bits) as numpy."""
    (jc, pc), (ja, pa) = _both(cap), _both(active)
    (jb, pb), (jt, ptl) = _both(boxes), _both(tiles)
    want = np.asarray(jpt._pair_bits(_j(O), _j(u), jb, nc, subg, BLK,
                                     cap=jc, active=ja, members=(jb, jt)))
    plain = ppt.pair_bits_plain(_p(O), _p(u), nc, subg, (pb, ptl), pc, pa)
    disp = ppt._pair_bits(_p(O), _p(u), nc, subg, (pb, ptl), cap=pc,
                          active=pa)
    assert plain.dtype == disp.dtype == torch.int32
    return want, plain.numpy(), disp.numpy()


def _key_pair(O, u, boxes, nc, cap, active, valid_n):
    """JAX (skey, n_act, shift) and the port's plain and dispatched ones,
    the keys as numpy and the counts as ints."""
    (jc, pc), (ja, pa) = _both(cap), _both(active)
    jb, pb = _both(boxes)
    js, jn, jsh = jpt._compact_key(_j(O), _j(u), jb, nc, jc, ja, valid_n)
    out = [(np.asarray(js), int(jn), jsh)]
    for fn in (ppt.compact_key_plain, ppt._compact_key):
        s, n, sh = fn(_p(O), _p(u), pb, nc, pc, pa, valid_n)
        assert s.dtype == torch.int32 and n.dtype == torch.int64 \
            and n.dim() == 0
        out.append((s.numpy(), int(n), sh))
    return out


@pytest.mark.parametrize("with_cap,with_active", CAP_ACTIVE)
@pytest.mark.parametrize("subg", [16, 32, 64])
def test_pair_bits_match_jax_on_adversarial_rays(adv, subg, with_cap,
                                                 with_active):
    O, u, boxes, tiles, cap, act = adv
    want, plain, disp = _bits_pair(O, u, boxes, tiles, N_TILES, subg,
                                   cap if with_cap else None,
                                   act if with_active else None)
    assert want.shape == (-(-N_TILES // 32), R // subg)
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(disp, want)
    # bit 31 set somewhere, and the words far from all ones
    assert (want < 0).any()
    assert np.unpackbits(want.view(np.uint8)).mean() < 0.75


def test_adversarial_rays_are_adversarial(adv):
    """The inputs hold what their docstring promises: signed zeros,
    origins on box planes that make NaN slab terms, zero-thickness boxes,
    caps at an enter distance, tile 31."""
    O, u, boxes, tiles, cap, act = adv
    zero = u == 0
    assert zero.any() and np.signbit(u[zero]).any() \
        and (~np.signbit(u[zero])).any()
    assert (boxes[:, 0:3] == boxes[:, 3:6]).any(axis=1).any()
    with np.errstate(invalid="ignore", divide="ignore"):
        nan = np.isnan((boxes[:, None, 0] - O[0][None, :])
                       * (np.float32(1.0) / u[0])[None, :])
    assert nan.sum() > 100
    assert (31 == tiles).any() and act.mean() < 1.0
    finite = np.isfinite(cap) & (cap > 0)
    hits = 0
    for b in range(0, N_BOXES, 200):  # caps equal to some box's enter
        e = enter_of(O, u, np.repeat(boxes[b:b + 1], R, axis=0))
        hits += int((finite & (cap == e)).sum())
    assert hits > 0


def test_pair_bits_do_not_depend_on_member_order(adv):
    """The OR over members and rays has no order: members shuffled give
    the same words (the kernel visits them in chunks of its own)."""
    O, u, boxes, tiles, cap, act = adv
    perm = np.random.default_rng(5).permutation(N_BOXES)
    pb = lambda b, t: ppt.pair_bits_plain(
        _p(O), _p(u), N_TILES, 16, (torch.from_numpy(b),
                                    torch.from_numpy(t)),
        torch.from_numpy(cap), torch.from_numpy(act))
    assert torch.equal(pb(boxes, tiles), pb(boxes[perm].copy(),
                                            tiles[perm].copy()))


@pytest.mark.parametrize("with_cap,with_active", CAP_ACTIVE)
@pytest.mark.parametrize("n_keys", [40, N_BOXES])
def test_compact_key_matches_jax_on_adversarial_rays(adv, n_keys, with_cap,
                                                     with_active):
    """Key mode 2 over 40 boxes and mode 1 over 1,100, the last 7 lanes
    past valid_n."""
    O, u, boxes, _, cap, act = adv
    mode = ppt._key_mode(n_keys, R)[0]
    assert mode == (2 if n_keys == 40 else 1)
    got = _key_pair(O, u, np.ascontiguousarray(boxes[:n_keys]), n_keys,
                    cap if with_cap else None, act if with_active else None,
                    R - 7)
    (js, jn, jsh) = got[0]
    for s, n, sh in got[1:]:
        np.testing.assert_array_equal(s, js)
        assert (n, sh) == (jn, jsh)
    assert 0 < jn < R - 7


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


def _padded(O, u, cap, active):
    """The cast padded to BLK as both packages pad it (``pad_rays``):
    numpy (O, u, cap, active) and the unpadded count."""
    Ov, uv, c, a, n = pad_rays(_p(O), _p(u), torch.from_numpy(cap), BLK,
                               torch.from_numpy(active))
    s = lambda v: np.stack([x.numpy() for x in v])
    return s(Ov), s(uv), c.numpy(), a.numpy(), n


@pytest.mark.parametrize("subg", [16, 32, 64])
@pytest.mark.parametrize("kind", ["camera", "scattered"])
def test_culling_matches_jax_on_the_cat(cat, kind, subg):
    """The cat's member boxes (bits) and tile boxes and unions of 4 (keys)
    on 4,000 rays padded to 4,096, seeded caps and shadow mask; the key's
    valid_n is the unpadded count."""
    jtab, ptab = cat
    O, u = _cat_rays(kind, 4000, seed=subg)
    rng = np.random.default_rng(3)
    cap = rng.uniform(1.0, 80.0, 4000).astype(np.float32)
    act = rng.random(4000) < 0.7
    O, u, cap, act, n = _padded(O, u, cap, act)
    nc = int(jtab.tile_aabb.shape[0])
    mb, mt = np.asarray(jtab.member_aabb), np.asarray(jtab.member_tile)
    np.testing.assert_array_equal(mb, ptab.member_aabb.numpy())
    for c, a in ((None, None), (cap, act)):
        want, plain, disp = _bits_pair(O, u, mb, mt, nc, subg, c, a)
        np.testing.assert_array_equal(plain, want)
        np.testing.assert_array_equal(disp, want)
        assert want.any()
    tile = np.asarray(jtab.tile_aabb)
    coarse, knc = jpt._coarse_aabb(jnp.asarray(tile), nc, 4)
    for boxes, k in ((tile, nc), (np.asarray(coarse), knc)):
        got = _key_pair(O, u, boxes, k, cap, act, n)
        for s, cnt, sh in got[1:]:
            np.testing.assert_array_equal(s, got[0][0])
            assert (cnt, sh) == got[0][1:]
        assert got[0][1] > 0


def test_cpu_tensors_leave_the_launch_counts_untouched(adv):
    """On CPU tensors the dispatching functions run the plain versions:
    the same results, and no kernel is counted."""
    O, u, boxes, tiles, cap, act = adv
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    before = dict(_kernels.LAUNCHES)
    members = (t(boxes), t(tiles))
    assert torch.equal(
        ppt._pair_bits(_p(O), _p(u), N_TILES, 32, members, t(cap), t(act)),
        ppt.pair_bits_plain(_p(O), _p(u), N_TILES, 32, members, t(cap),
                            t(act)))
    a = ppt._compact_key(_p(O), _p(u), t(boxes[:40]), 40, t(cap), t(act), R)
    b = ppt.compact_key_plain(_p(O), _p(u), t(boxes[:40]), 40, t(cap),
                              t(act), R)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) \
        and a[2] == b[2]
    assert _kernels.LAUNCHES == before
    assert set(_kernels.CULLING) <= set(_kernels.LAUNCHES)
