"""The mesh casts' glue and the trace's backward composite (ops/
pallas_trace.py ``ray_rows``, ops/pairs_trace.py ``compact_rows`` and
``scatter``, integrator/wavefront.py ``composite``), whose kernels are
csrc/glue.cu's, through their plain versions on the CPU.

- ``ray_rows_plain`` against the JAX package's ``_ray_feature_rows`` (pad
  on and off, no extra, ``cap``, ``cap`` and the mask) and
  ``_ray_features16``, on bench/cast_glue.hard_rays (NaN, infinite, huge,
  zero, -0.0 and denormal components, padding lanes) and on scattered
  rays;
- ``compact_rows_plain`` against ``jnp.take`` of the JAX live rows at the
  JAX ``_compact_sort``'s lanes, on the same key (bitwise across the
  packages: tests/test_torch_compact.py), exact and coarse;
- ``scatter_plain`` against the JAX ``.at[src].set`` over its defaults;
- ``composite_plain`` against the JAX package's composite scan on injected
  steps, D = 1 to 8, ``is_diff`` all true, none and mixed, and against an
  f64 numpy model of ``core/vec.fma`` bit for bit.

The standard: data movement (the copied rows, the source lanes, the
scatter) is bitwise, NaNs as one value.  ``w = O x u``, ``1 / u`` and the
composite are bitwise where XLA:CPU's fused multiply-add rounds as
``core/vec.fma``'s f64 sum does (they differ only at an f32 midpoint):
measured here on 100% of the lanes of every case; the tests hold every
lane within 1 ulp and at least 99.99% of them bitwise.

Structural cases: the one-pass scatter through the whole sorted keys (the
kernel's design, a numpy model here) equals the two-op scatter of the plain
version on random permutations with C = 0, C = Rp and padding lanes; the
pairs casts and whole frames through the new dispatchers on the CPU are
bit for bit the parent's path (copies of its code kept here); CPU tensors
never reach ops/_kernels and other devices raise; bench/cast_glue.py's
capture, plain-glue patching, hard calls and bounds run.

No test here imports a JAX bench module (ROADMAP C3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.core.vec import vwhere as j_vwhere
from raytracinggpu_tpu.ops import pairs_trace as jpt
from raytracinggpu_tpu.ops import pallas_trace as jpat
from raytracinggpu_tpu_torch.bench import cast_glue as cg
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.core.vec import fma
from raytracinggpu_tpu_torch.integrator import wavefront as pwf
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.ops import pallas_trace as ppat
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

R = 8192
INF32 = ppt.INF32


def _jv(v):
    return JV(*(jnp.asarray(c.numpy()) for c in v))


def _ulps(a, b):
    """|a - b| in f32 units in the last place, 0 where both are NaN (as
    ordered integers: the sign-magnitude bits folded onto one line)."""
    def line(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    d = np.abs(line(a) - line(b))
    return np.where(np.isnan(a) & np.isnan(b), 0, d)


def _hold(got, want, arithmetic=()):
    """Rows (n, ...) of the port against the JAX package's: bitwise (NaNs
    as one value), but the ``arithmetic`` rows within 1 ulp with at least
    99.99% of their lanes bitwise."""
    assert got.shape == want.shape and got.dtype == want.dtype
    for r in range(got.shape[0]):
        d = _ulps(got[r], want[r])
        if r in arithmetic:
            assert d.max() <= 1 and (d == 0).mean() >= 0.9999, r
        else:
            assert (d == 0).all(), r


@pytest.fixture(scope="module")
def cat():
    """The cat's pairs tables in both packages (bitwise the same:
    tests/test_torch_scene.py)."""
    mesh = load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))
    return (jpt.build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh),
            ppt.build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh, "cpu"))


@pytest.fixture(scope="module")
def scattered():
    """tests/test_compact.py's scattered rays (seed 7), a seeded cap and
    mask, as port tensors."""
    rng = np.random.default_rng(7)
    O = rng.uniform(-25, 25, (3, R)).astype(np.float32)
    d = rng.normal(size=(3, R)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    cap = rng.uniform(0.0, 40.0, R).astype(np.float32)
    act = rng.uniform(size=R) < 0.5
    T = torch.from_numpy
    return PV(*map(T, O)), PV(*map(T, d)), T(cap), T(act)


def _extras(cap, active):
    """The JAX callers' extra rows: (cap,), or (cap or zeros, the mask as
    f32), as ``raytracinggpu_tpu/ops/pairs_trace.py`` builds them."""
    if active is not None:
        c = jnp.asarray(cap.numpy()) if cap is not None else \
            jnp.zeros(active.shape[0], jnp.float32)
        return (c, jnp.asarray(active.numpy()).astype(jnp.float32))
    return () if cap is None else (jnp.asarray(cap.numpy()),)


# ---------------------------------------------------------------- ray rows

@pytest.mark.parametrize("rays", ["hard", "scattered"])
@pytest.mark.parametrize("layout,extras", [
    ("pairs", ""), ("live", ""), ("live", "cap"), ("live", "active"),
    ("live", "cap active"), ("pairs", "cap active")])
def test_ray_rows_plain_matches_jax(scattered, rays, layout, extras):
    O, u, cap, act = (cg.hard_rays(R, "cpu", 3) if rays == "hard"
                      else scattered)
    cap = cap if "cap" in extras else None
    act = act if "active" in extras else None
    want = np.asarray(jax.jit(
        lambda O, u, e: jpt._ray_feature_rows(O, u, e, pad=layout == "pairs")
    )(_jv(O), _jv(u), _extras(cap, act)))
    got = ppat.ray_rows_plain(O, u, cap, act, layout).numpy()
    assert got.shape[0] == _kernels.ray_row_count(cap, act, layout)
    _hold(got, want, arithmetic=(3, 4, 5))


@pytest.mark.parametrize("rays", ["hard", "scattered"])
def test_ray_rows_plain_pallas_layout_matches_jax(scattered, rays):
    O, u, _, _ = cg.hard_rays(R, "cpu", 4) if rays == "hard" else scattered
    want = np.asarray(jax.jit(jpat._ray_features16)(_jv(O), _jv(u))).T
    got = ppat.ray_rows_plain(O, u, layout="pallas").numpy()
    _hold(got, np.ascontiguousarray(want), arithmetic=(3, 4, 5, 9, 10, 11))
    # the tiled casts' rows are this layout (the dispatcher on the CPU)
    assert cg.same_bits([ppat._ray_features16(O, u)],
                        [ppat.ray_rows_plain(O, u, layout="pallas")])


def test_ray_row_layouts_refuse_what_they_do_not_hold(scattered):
    O, u, cap, act = scattered
    with pytest.raises(ValueError, match="layout"):
        ppat.ray_rows_plain(O, u, layout="tiled")
    with pytest.raises(ValueError, match="no cap or active"):
        ppat.ray_rows_plain(O, u, cap, layout="pallas")
    assert [_kernels.ray_row_count(c, a, "live") for c, a in (
        (None, None), (cap, None), (None, act), (cap, act))] == [9, 10, 11, 11]


# ----------------------------------------------------------- compact rows

@pytest.mark.parametrize("with_cap,with_active,g", [
    (False, False, 1), (True, False, 1), (False, True, 1), (True, True, 1),
    (True, True, 4)])
def test_compact_rows_plain_matches_jax(cat, scattered, with_cap,
                                        with_active, g):
    """A 2,048-ray tier's rows over the cat's tile boxes (g = 4: unions of
    4), the last 5 lanes padding."""
    jtab, ptab = cat
    O, u, cap, act = scattered
    cap = cap if with_cap else None
    act = act if with_active else None
    aabb = np.array(jtab.tile_aabb)
    nc, C = aabb.shape[0], 2048
    kn = -(-nc // g)
    jb, pb = jnp.asarray(aabb), torch.from_numpy(aabb)
    if g > 1:
        jb, pb = jpt._coarse_aabb(jb, nc, g)[0], ppt._coarse_aabb(pb, nc, g)[0]
    jc = None if cap is None else jnp.asarray(cap.numpy())
    ja = None if act is None else jnp.asarray(act.numpy())
    skey, jn, shift = jpt._compact_key(_jv(O), _jv(u), jb, kn, jc, ja, R - 5)
    jsrc = jpt._compact_sort(skey, C, shift)
    want = np.asarray(jax.jit(lambda O, u, e, src: jnp.take(
        jpt._ray_feature_rows(O, u, e, pad=False), src, axis=1))(
            _jv(O), _jv(u), _extras(cap, act), jsrc))

    pkey, pn, pshift = ppt.compact_key_plain(O, u, pb, kn, cap, act, R - 5)
    assert pshift == shift and int(pn) == int(jn)
    np.testing.assert_array_equal(pkey.numpy(), np.asarray(skey))
    plan = ppt._compact_sort(pkey, C, pshift)
    got, src, act_c = ppt.compact_rows_plain(*plan, O, u, cap, act)
    assert src.dtype == torch.int32
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    _hold(got.numpy(), want, arithmetic=(3, 4, 5))
    if act is None:
        assert act_c is None
    else:
        np.testing.assert_array_equal(act_c.numpy(), want[10] > 0.5)
    # the sorted keys hold every lane once
    lanes = plan.keys & ((1 << shift) - 1)
    assert torch.equal(lanes.sort().values, torch.arange(R, dtype=torch.int32))


# ---------------------------------------------------------------- scatter

def _permutation_keys(Rp, valid_n, seed):
    """Sorted keys of Rp lanes, the ladder's way: a random group (8 bits)
    over the lane, lanes past valid_n (padding) given the inactive marker
    so that they sort last; returns (keys, shift)."""
    rng = np.random.default_rng(seed)
    shift = max((Rp - 1).bit_length(), 1)
    group = rng.integers(0, 255, Rp).astype(np.int64)
    group[valid_n:] = 255
    keys = np.sort((group << shift) | np.arange(Rp)).astype(np.int32)
    return torch.from_numpy(keys), shift


def _one_pass(keys, C, shift, outs, defaults):
    """The kernel rt_scatter's design in numpy: position i of the sorted
    keys writes lane key[i] & mask, the cast's output i where i < C, else
    the default."""
    k = keys.numpy()
    lane = k & ((1 << shift) - 1)
    res = []
    for o, d in zip(outs, defaults):
        o = o.numpy()
        out = np.empty(len(k), o.dtype)
        vals = np.concatenate([o, np.full(len(k) - len(o), d, o.dtype)])
        out[lane] = vals
        res.append(out)
    return res


@pytest.mark.parametrize("Rp,C,valid_n", [
    (4096, 0, 4096), (4096, 4096, 4096), (4096, 1000, 3900), (8192, 17, 8000),
    (1, 1, 1), (3000, 2999, 2500)])
@pytest.mark.parametrize("n_out", [1, 2, 5])
def test_one_pass_scatter_equals_the_two_op_scatter(Rp, C, valid_n, n_out):
    keys, shift = _permutation_keys(Rp, valid_n, Rp + C)
    rng = np.random.default_rng(C)
    dts = (torch.float32, torch.int32) + (torch.float32,) * 3
    outs = tuple(torch.from_numpy(
        rng.integers(-2**31, 2**31, C).astype(np.int32)).view(dt)
        for dt in dts[:n_out])
    defaults = ppt.NO_HIT[:n_out]
    got = ppt.scatter_plain(keys, C, shift, outs, defaults)
    want = _one_pass(keys, C, shift, outs, defaults)
    for g, w, o in zip(got, want, outs):
        assert g.dtype == o.dtype and g.shape == (Rp,)
        np.testing.assert_array_equal(g.view(torch.int32).numpy(),
                                      w.view(np.int32))


@pytest.mark.parametrize("C", [0, 700, 2048])
def test_scatter_plain_matches_jax(C):
    """The JAX casts' ``.at[src].set`` over INF, 0 and 0.0 (its closest
    cast's five outputs; its shadow cast's one is the first)."""
    Rp = 2048
    keys, shift = _permutation_keys(Rp, Rp - 100, C)
    src = keys[:C] & ((1 << shift) - 1)
    rng = np.random.default_rng(5)
    outs = (torch.from_numpy(rng.uniform(0, 90, C).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 4000, C).astype(np.int32)),
            *(torch.from_numpy(rng.normal(size=C).astype(np.float32))
              for _ in range(3)))
    js = jnp.asarray(src.numpy())
    want = [jnp.full((Rp,), jpt.INF, jnp.float32),
            jnp.zeros((Rp,), jnp.int32)] + [jnp.zeros((Rp,), jnp.float32)] * 3
    want = [np.asarray(w.at[js].set(jnp.asarray(o.numpy())))
            for w, o in zip(want, outs)]
    got = ppt.scatter_plain(keys, C, shift, outs, ppt.NO_HIT)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------- composite

def _jax_composite(types, directs, albedos):
    """The JAX package's backward composite, the scan of
    raytracinggpu_tpu/integrator/wavefront.py::trace (:413-420) as it is
    written there, on stacked steps."""
    def comp_step(ans, xs):
        is_diff, direct, alb = xs
        ans = j_vwhere(is_diff, alb * ans + direct, ans)
        return ans, None

    R = types.shape[1]
    ans, _ = jax.lax.scan(comp_step, JV.zeros((R,)),
                          (types, directs, albedos), reverse=True)
    return ans


def _steps(D, diff, n=4096, seed=0):
    """(is_diff (D, n), direct (D, 3, n), alb (D, 3, n)) numpy steps."""
    rng = np.random.default_rng(seed + D)
    is_diff = {"all": np.ones((D, n), bool), "none": np.zeros((D, n), bool),
               "mixed": rng.random((D, n)) < 0.7}[diff]
    return (is_diff, rng.uniform(0, 50, (D, 3, n)).astype(np.float32),
            rng.uniform(0, 1, (D, 3, n)).astype(np.float32))


def _port_steps(is_diff, direct, alb):
    T = torch.from_numpy
    return [(T(is_diff[d]), T(direct[d]), T(alb[d]))
            for d in range(len(is_diff))]


@pytest.mark.parametrize("diff", ["all", "none", "mixed"])
@pytest.mark.parametrize("D", range(1, 9))
def test_composite_plain_matches_jax(D, diff):
    is_diff, direct, alb = _steps(D, diff)
    stack = lambda a: JV(*(jnp.asarray(a[:, c]) for c in range(3)))
    want = jax.jit(_jax_composite)(jnp.asarray(is_diff), stack(direct),
                                   stack(alb))
    want = np.stack([np.asarray(c) for c in want])
    got = pwf.composite_plain(_port_steps(is_diff, direct, alb),
                              is_diff.shape[1], "cpu").numpy()
    _hold(got, want, arithmetic=(0, 1, 2))
    # an f64 model of core/vec.fma: the exact product, the f64 sum, one
    # rounding to f32, bit for bit
    ans = np.zeros((3, is_diff.shape[1]), np.float32)
    for d in reversed(range(D)):
        new = (alb[d].astype(np.float64) * ans + direct[d]).astype(np.float32)
        ans = np.where(is_diff[d], new, ans)
    np.testing.assert_array_equal(got, ans)
    if diff == "none":
        assert not got.any()


# ------------------------------------- the parent's path, kept to hold it

def _old_ray_feature_rows(O, u, extra=(), pad=True):
    w = O.cross(u)
    rows = [u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z, *extra]
    if pad:
        rows += [torch.zeros_like(u.x)] * (16 - len(rows))
    return torch.stack(rows, dim=0).contiguous()


def _old_live_rows(O, u, cap, active):
    extra = () if cap is None else (cap,)
    if active is not None:
        extra = (torch.zeros_like(O.x) if cap is None else cap,
                 active.to(torch.float32))
    return _old_ray_feature_rows(O, u, extra, pad=False)


def _old_ladder(O, u, tab, cap, active, fractions, key_coarse, blk,
                valid_n):
    tiers, boxes, knc = ppt._ladder_tiers(tab, fractions, key_coarse,
                                          O.x.shape[0], blk)
    if not tiers:
        return None
    skey, n_act, shift = ppt._compact_key(O, u, boxes, knc, cap, active,
                                          valid_n)
    count = ppt._count_pending(n_act)
    rows = _old_live_rows(O, u, cap, active)
    C = ppt._tier(tiers, count)
    if not C:
        return rows, None
    src = (torch.sort(skey).values[:C] & ((1 << shift) - 1)).long()
    return rows.index_select(1, src), src


def _old_scatter(src, out, Rp, defaults):
    return [torch.full((Rp,), d, dtype=o.dtype, device=o.device)
            .index_copy_(0, src, o) for o, d in zip(out, defaults)]


def _old_rows_bits(O, u, tab, subg, blk, cap, active, fractions, key_coarse):
    O, u, cap, active, R = ppt.pad_rays(O, u, cap, blk, active)
    Rp = O.x.shape[0]
    plan = _old_ladder(O, u, tab, cap, active, fractions, key_coarse, blk, R)
    if plan is None:
        return (_old_ray_feature_rows(O, u),
                ppt._bits(O, u, tab, subg, cap, active), None, Rp, R)
    rf, src = plan
    if src is not None:
        O, u = PV(rf[6], rf[7], rf[8]), PV(rf[0], rf[1], rf[2])
        cap = None if cap is None else rf[9]
        active = None if active is None else rf[10] > 0.5
    return rf, ppt._bits(O, u, tab, subg, cap, active), src, Rp, R


def _old_closest(O, u, tab, eps_leaf, cap=None, subg=ppt.DEF_SUBG,
                 blk=ppt.DEF_BLK, payload=None, compact=0.0, compact2=0.0,
                 compact3=0.0, key_coarse=1):
    kernel = {None: ppt.pairs_closest_idx, "geom": ppt.pairs_closest,
              "smooth": ppt.pairs_closest_smooth}[payload]
    rfT, bits, src, Rp, R = _old_rows_bits(
        O, u, tab, subg, blk, cap, None, (compact, compact2, compact3),
        key_coarse)
    out = kernel(rfT, tab.fields, bits, eps_leaf, subg, ppt.tile_width(tab))
    if src is not None:
        out = _old_scatter(src, out, Rp, (INF32, 0, 0.0, 0.0, 0.0))
    out = [o[:R] for o in out]
    hit = ppt.TriHit(t=out[0], idx=out[1])
    return (hit, PV(*out[2:])) if payload else hit


def _old_shadow(O, u, tab, eps_leaf, cap=None, subg=ppt.DEF_SUBG,
                blk=ppt.DEF_BLK, active=None, compact=0.0, compact2=0.0,
                compact3=0.0, key_coarse=1):
    rfT, bits, src, Rp, R = _old_rows_bits(
        O, u, tab, subg, blk, cap, active, (compact, compact2, compact3),
        key_coarse)
    t = ppt.pairs_shadow(rfT, tab.fields, bits, eps_leaf, subg,
                         ppt.tile_width(tab))
    if src is not None:
        t = _old_scatter(src, (t,), Rp, (INF32,))[0]
    return t[:R]


def _old_features16(O, u):
    w = O.cross(u)
    z = torch.zeros_like(u.x)
    return torch.stack([u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z,
                        1.0 / u.x, 1.0 / u.y, 1.0 / u.z, z, z, z, z])


def _old_composite(steps, R, device):
    ans = torch.zeros((3, R), dtype=torch.float32, device=device)
    for is_diff, direct, alb in reversed(steps):
        ans = torch.where(is_diff, fma(alb, ans, direct), ans)
    return ans


def _same(a, b):
    if a is None or b is None:
        return a is b
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int32) if a.dtype == torch.float32 else a,
        b.view(torch.int32) if b.dtype == torch.float32 else b)


@pytest.mark.parametrize("payload", [None, "geom", "smooth"])
@pytest.mark.parametrize("fracs", [(0.0, 0.0, 0.0), (0.25, 0.0, 0.0),
                                   (0.05, 0.0, 0.0), (0.02, 0.04, 0.5)])
def test_pairs_casts_through_the_new_dispatchers_are_the_parents(
        cat, scattered, payload, fracs):
    """The closest cast (each payload) and the shadow cast, full width,
    compacted and overflowing every tier, with a cap and a mask: bit for
    bit the parent's code on every lane, padding included."""
    _, tab = cat
    O, u, cap, act = scattered
    n = R - 37  # padded to whole 512-ray blocks
    cut = lambda v: PV(*(c[:n] for c in v))
    Oc, uc, cc, ac = cut(O), cut(u), cap[:n], act[:n]
    kw = dict(blk=512, compact=fracs[0], compact2=fracs[1],
              compact3=fracs[2])
    new = ppt.intersect_tris_pairs(Oc, uc, tab, 1e-4, cap=cc,
                                   payload=payload, **kw)
    old = _old_closest(Oc, uc, tab, 1e-4, cap=cc, payload=payload, **kw)
    flat = lambda h: [*h[0], *h[1]] if payload else [*h]
    assert all(_same(a, b) for a, b in zip(flat(new), flat(old)))
    t = ppt.intersect_tris_pairs_shadow(Oc, uc, tab, 1e-4, cap=cc,
                                        active=ac, **kw)
    t_old = _old_shadow(Oc, uc, tab, 1e-4, cap=cc, active=ac, **kw)
    assert _same(t, t_old)


FRAMES = {
    "array_bvh ladder at every depth": ("array_bvh", dict(
        pairs_block=128, pairs_compact_min_depth=0)),
    "array_bvh ladder overflowing": ("array_bvh", dict(
        pairs_block=128, pairs_compact=0.02, pairs_compact2=0.03,
        pairs_compact3=0.04)),
    "array_bvh pallas": ("array_bvh", dict(traversal="pallas")),
    "realtime": ("realtime", {}),
    "showcase": ("showcase", {}),
}


@pytest.mark.parametrize("frame", list(FRAMES))
def test_frames_through_the_new_dispatchers_are_the_parents(frame,
                                                            monkeypatch):
    name, kw = FRAMES[frame]
    cfg, tab = build_preset(name, "cpu", width=24, height=20, spp=2,
                            max_depth=3, **kw)
    img, st = render_preset_frame(tab, cfg, seed=0)
    monkeypatch.setattr(pwf, "intersect_tris_pairs", _old_closest)
    monkeypatch.setattr(pwf, "intersect_tris_pairs_shadow", _old_shadow)
    monkeypatch.setattr(ppat, "_ray_features16", _old_features16)
    monkeypatch.setattr(pwf, "composite", _old_composite)
    img_o, st_o = render_preset_frame(tab, cfg, seed=0)
    np.testing.assert_array_equal(img.view(np.int32), img_o.view(np.int32))
    for a, b in zip(st, st_o):
        np.testing.assert_array_equal(a, b)
    assert int(st.hit[0]) == 24 * 20 * 2


def test_a_trace_of_no_depth_composes_zero():
    ans = pwf.composite([], 5, "cpu")
    assert ans.shape == (3, 5) and not ans.any()


# ------------------------------------------------------ dispatch on the CPU

def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached ops/_kernels")

    cfg, tab = build_preset("array_bvh", "cpu", width=16, height=12, spp=2,
                            max_depth=3, pairs_block=128,
                            pairs_compact_min_depth=0)
    want = render_preset_frame(tab, cfg, seed=0)
    for name in _kernels.GLUE:
        monkeypatch.setattr(_kernels, name, refuse)
    before = dict(_kernels.LAUNCHES)
    img, _ = render_preset_frame(tab, cfg, seed=0)
    assert _kernels.LAUNCHES == before
    np.testing.assert_array_equal(img, want[0])


def test_other_devices_raise():
    x = torch.zeros(4, device="meta")
    v = PV(x, x, x)
    k = torch.zeros(4, dtype=torch.int32, device="meta")
    for call in (lambda: ppat.ray_rows(v, v),
                 lambda: ppat._ray_features16(v, v),
                 lambda: ppt._live_rows(v, v, None, None),
                 lambda: ppt.compact_rows(k, 2, 2, v, v),
                 lambda: ppt.scatter(k, 2, 2, (x[:2],), (0.0,)),
                 lambda: pwf.composite([(x.bool(), x, x)], 4, "meta")):
        with pytest.raises(ValueError, match="CUDA or CPU"):
            call()


# ----------------------------------------- bench/cast_glue.py on the CPU

def test_capture_keeps_the_glue_calls_of_the_first_depths():
    """The pairs frame with the ladder at every depth and a tier that
    takes: the first trace's depths 0-1 keep each cast's rows (compacted,
    then scattered back) and the trace's composite; every kept call reruns
    to the same bits through the plain version (the dispatchers run it
    on the CPU too), and the dispatchers are put back."""
    cfg, tab = build_preset("array_bvh", "cpu", width=16, height=16, spp=2,
                            max_depth=3, pairs_block=128,
                            pairs_compact_min_depth=0, pairs_compact=0.5)
    kept, (img, _) = cg.capture(lambda: render_preset_frame(tab, cfg, 0),
                                depths=2)
    labels = {k: [(lab, kind) for lab, kind, _ in v] for k, v in kept.items()}
    assert [kind for _, kind in labels["compact_rows"]] == [
        "closest", "shadow"] * 2
    assert [kind for _, kind in labels["scatter"]] == ["closest", "shadow"] * 2
    assert labels["compact_rows"][2][0].startswith("trace 0 depth 1 closest")
    assert "key mode 2" in labels["compact_rows"][0][0]
    assert labels["ray_rows"] == []
    assert labels["composite"] == [("trace 0, 3 depths", "composite")]
    assert ppt.compact_rows.__name__ == "compact_rows"
    assert pwf.composite.__name__ == "composite"
    for kernel, calls in kept.items():
        for _, _, args in calls:
            assert cg.same_bits(cg.call(kernel, args, False),
                                cg.call(kernel, args, True))
    with cg.plain_glue():
        assert ppt.scatter is ppt.scatter_plain
        assert ppat.ray_rows is ppat.ray_rows_plain
        img_p, _ = render_preset_frame(tab, cfg, 0)
    assert ppt.scatter.__name__ == "scatter"
    np.testing.assert_array_equal(img, img_p)


@pytest.mark.parametrize("kw,size,layouts", [
    (dict(), 16, ["pairs"] * 4),  # no tier below a 4,096-ray cast
    (dict(traversal="pallas"), 16, ["pallas"] * 4),
    # one tier of 128 rays, which every cast overflows
    (dict(pairs_block=128, pairs_compact_min_depth=0, pairs_compact=0.02,
          pairs_compact2=0.0, pairs_compact3=0.0), 48, ["live"] * 4)])
def test_capture_labels_the_full_width_and_tiled_rows(kw, size, layouts):
    cfg, tab = build_preset("array_bvh", "cpu", width=size, height=size,
                            spp=1, max_depth=2, **kw)
    kept, _ = cg.capture(lambda: render_preset_frame(tab, cfg, 0))
    assert [kind for _, kind, _ in kept["ray_rows"]] == layouts
    assert [lab for lab, _, _ in kept["ray_rows"]] == [
        f"trace 0 depth {d} {q}" for d in (0, 1)
        for q in ("closest", "shadow")]
    assert kept["compact_rows"] == kept["scatter"] == []


def test_adversarial_calls_run_through_the_plain_versions():
    calls = cg.adversarial_calls("cpu", R=4096, seed=1)
    kinds = {k for k, *_ in calls}
    assert kinds == set(cg.STAGES)
    for kernel, label, _, args in calls:
        got = cg.call(kernel, args, False)
        assert cg.same_bits(got, cg.call(kernel, args, True)), label
        ms, by = cg.call_bound(kernel, args, got)
        assert by in ("bytes", "operations")
        assert ms > 0 or kernel == "compact_rows" and args[1] == 0
    # the widths cover C = 0 and C = Rp, the composites a second launch
    labels = [lab for k, lab, *_ in calls if k == "compact_rows"]
    assert any(lab.startswith("C 0 ") for lab in labels)
    assert any(lab.startswith("C 4096 of 4096") for lab in labels)
    assert max(len(a[0]) for k, _, _, a in calls if k == "composite") \
        > _kernels.COMPOSITE_DEPTHS


def test_bounds_count_each_input_once():
    O, u, cap, act = cg.hard_rays(1024, "cpu")
    rows = ppat.ray_rows_plain(O, u, cap, act, "live")
    assert cg.call_work("ray_rows", (O, u, cap, act, "live"), [rows]) == (
        1024 * (24 + 4 + 1) + 11 * 1024 * 4, 6 * 1024)
    keys = cg.sorted_keys(1024, 10, "cpu")
    out = ppt.compact_rows_plain(keys, 100, 10, O, u, cap, act)
    assert cg.call_work("compact_rows", (keys, 100, 10, O, u, cap, act),
                        cg.flatten(out)) == (
        100 * 4 + 100 * 29 + 100 * (11 * 4 + 4 + 1), 600)
    steps = ((act, rows[:3].contiguous(), rows[3:6].contiguous()),)
    ans = pwf.composite_plain(steps, 1024, "cpu")
    assert cg.call_work("composite", (steps, 1024, "cpu"), [ans]) == (
        1024 * 25 + 1024 * 12, 6 * int(act.sum()))
    assert cg.call_bound("scatter", (keys, 100, 10, (rows[0, :100],),
                                     (0.0,)), [rows[0]])[1] == "bytes"


@pytest.mark.parametrize("fracs,want", [
    ((0.25, 0.0, 0.0), "COMPACTED"), ((0.02, 0.0, 0.0), "OVERFLOWED"),
    ((0.0, 0.0, 0.0), "FULL_WIDTH")])
def test_the_ladder_stages_still_read(cat, scattered, fracs, want):
    """bench/ladder.py's STAGES name functions of ops/pairs_trace.py, and a
    cast runs exactly the stages its kind lists (timed here on the host
    clock, as utils/profiling.stage_timers does on the CPU); every stage
    of utils/profiling.STAGES names a function of its module."""
    from raytracinggpu_tpu_torch.bench import ladder
    from raytracinggpu_tpu_torch.utils import profiling

    _, tab = cat
    O, u, cap, _ = scattered
    stages = [(ladder._PT, f) for f in ladder.STAGES]
    with profiling.stage_timers(torch.device("cpu"), stages) as st:
        ppt.intersect_tris_pairs(O, u, tab, 1e-4, cap=cap, blk=512,
                                 payload="geom", compact=fracs[0])
    assert sorted({ladder.STAGES[f] for f in st}) == sorted(
        getattr(ladder, want))
    for mod, attr in profiling.STAGES:
        assert callable(getattr(__import__(mod, fromlist=[attr]), attr))
