"""The port's skip-link BVH walk (``traversal="bvh"``,
raytracinggpu_tpu_torch/ops/bvh_traverse.py) against the JAX package's
and against the dense oracle.

Both walks visit the same nodes with the same slab test; their leaf tests
sum the ten Moller-Trumbore terms in another order (the JAX walk in an
``einsum``, the port left to right), so the standard against the JAX walk
is the dense oracle's of ROADMAP Queue C: hit/miss, id and t within rtol
1e-5 agree on >= 99.9% of the rays, and |dt| <= 1e-5 * max(t, 1) where
the ids agree.  Measured on these rays: every ray agrees on hit/miss and
id, t bitwise on 87% of them and within 1.1e-6 relative on all.  Within
the port the ``soa`` and ``aos10`` layouts must be bitwise equal, the
batched leaf test must equal the JAX walk's sequential strict-``<``
updates exactly, and the cases of ``tests/test_bvh_traverse.py`` hold:
the walk against the dense scan on the cat, and a full trace through
``bvh`` against ``dense``.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.ops.bvh_traverse import intersect_tris_bvh as j_walk
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.convert import scene_tables_from_numpy
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.integrator.wavefront import trace
from raytracinggpu_tpu_torch.ops.bvh_traverse import (
    MAX_LEAF_TRIS,
    intersect_tris_bvh,
    leaf_test,
)
from raytracinggpu_tpu_torch.ops.triangle import (
    INF32,
    intersect_tris_dense,
    ray_features,
)
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

EPS = 1e-4
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "array_bvh_48.npy")


@pytest.fixture(scope="module")
def tables():
    """The JAX package's array_bvh tables and the port's copy of them."""
    _, jt = j_build_preset("array_bvh", width=8, height=8, spp=1,
                           max_depth=1)
    return jt, scene_tables_from_numpy(jax.tree.map(np.asarray, jt), "cpu")


def _rays(n=4096, seed=1234):
    """Seeded rays from the box [-30, 30]^3: half in random directions,
    half aimed at points of the cat's box."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    tgt = rng.uniform([-8, -10, -5], [8, 2, 5], (n, 3)).astype(np.float32)
    d[::2] = (tgt - o)[::2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _pv(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _jv(a):
    return JV(*(jnp.asarray(a[:, i]) for i in range(3)))


@pytest.fixture(scope="module")
def jax_walk(tables):
    jt, _ = tables
    o, d = _rays()
    h = jax.jit(lambda O, u: j_walk(O, u, jt.mesh, jt.bvh, EPS))(
        _jv(o), _jv(d))
    return jax.tree.map(np.asarray, h)


@pytest.mark.parametrize("layout", ["soa", "aos10"])
def test_walk_matches_jax(tables, jax_walk, layout):
    _, pt = tables
    o, d = _rays()
    ph = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS,
                            node_layout=layout)
    tj, tp = jax_walk.t, ph.t.numpy()
    hj, hp = tj < INF32, tp < INF32
    assert hp.sum() > 1000       # half the rays aim at the cat
    same = (hj == hp) & (jax_walk.idx == ph.idx.numpy())
    close = np.abs(tp - tj) <= 1e-5 * np.abs(tj)
    assert (same & (close | ~hp)).mean() >= 0.999
    assert (np.abs(tp - tj)[same & hp]
            <= 1e-5 * np.maximum(tj[same & hp], 1.0)).all()
    np.testing.assert_allclose(ph.beta.numpy()[same & hp],
                               jax_walk.beta[same & hp], rtol=1e-4,
                               atol=1e-5)


def test_layouts_are_bitwise_equal(tables):
    _, pt = tables
    o, d = _rays(seed=7)
    a = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS)
    b = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS,
                           node_layout="aos10")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_walk_matches_dense_on_the_cat(tables):
    """tests/test_bvh_traverse.py's case: the walk and the dense scan on
    rays from the box in random directions."""
    _, pt = tables
    o, d = _rays(n=2048, seed=3)
    bh = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS)
    dh = intersect_tris_dense(_pv(o), _pv(d), pt.mesh, EPS)
    tb, td = bh.t.numpy(), dh.t.numpy()
    hb, hd = tb < INF32, td < INF32
    np.testing.assert_array_equal(hb, hd)
    np.testing.assert_allclose(tb[hb], td[hd], rtol=1e-5, atol=1e-5)
    assert (bh.idx.numpy() == dh.idx.numpy())[hb].mean() > 0.995


def test_leaf_test_is_the_sequential_strict_min():
    """The batched leaf test equals the JAX walk's unrolled updates (a
    strict < in triangle order) exactly, exact-t ties included: every
    triangle of the table appears twice, so every hit has a tie."""
    rng = np.random.default_rng(5)
    T, n = 24, 300
    A = rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    B = A + rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    C = A + rng.uniform(-1, 1, (T, 3)).astype(np.float32)
    from raytracinggpu_tpu_torch.ops.triangle import build_tri_tables

    tab = build_tri_tables(*(np.repeat(v, 2, axis=0) for v in (A, B, C)),
                           "cpu")
    mtT = tab.mt.reshape(40, -1).T.contiguous()
    start = torch.from_numpy(rng.integers(0, 2 * T - 1, n))
    # each ray aims at a point inside the first triangle of its range
    w = rng.dirichlet((1.0, 1.0, 1.0), n).astype(np.float32)
    s0 = start.numpy() // 2
    tgt = w[:, :1] * A[s0] + w[:, 1:2] * B[s0] + w[:, 2:] * C[s0]
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = tgt - o
    f = ray_features(_pv(o), _pv(d))
    count = torch.from_numpy(rng.integers(0, 12, n)).clamp_max(2 * T - start)
    t, idx, beta, gamma = leaf_test(f, mtT, start, count, EPS)
    hits = 0
    for r in range(n):
        best, bi, bb, bg = INF32, 0, 0.0, 0.0
        for k in range(int(count[r])):
            ti = int(start[r]) + k
            s = f[r, :, None] * mtT[ti].view(10, 4)
            acc = s[0]
            for j in range(1, 10):
                acc = acc + s[j]
            den, bn, gn, tn = acc
            b, g, tt = bn / den, gn / den, tn / den
            ok = (den != 0 and 0 <= b <= 1 and 0 <= g <= 1 and b + g <= 1
                  and tt > 0 and tt > np.float32(EPS))
            if ok and tt < best:
                best, bi, bb, bg = tt, ti, b, g
        hits += best < INF32
        assert float(t[r]) == float(best)
        if best < INF32:
            assert (int(idx[r]), float(beta[r]), float(gamma[r])) == (
                bi, float(bb), float(bg))
    assert hits > n // 2


def test_leaf_cap_matches_jax(tables):
    """Triangles past bvh_max_leaf are never tested, in either package."""
    jt, pt = tables
    o, d = _rays(n=1024, seed=11)
    cap = 3
    jh = jax.tree.map(np.asarray, j_walk(_jv(o), _jv(d), jt.mesh, jt.bvh,
                                         EPS, max_leaf_tris=cap))
    ph = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS,
                            max_leaf_tris=cap)
    full = intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS)
    same = ((jh.t < INF32) == (ph.t.numpy() < INF32)) & (
        jh.idx == ph.idx.numpy())
    assert same.mean() >= 0.999
    # the cap loses hits in the cat's long leaves
    assert (ph.t.numpy() < INF32).sum() < (full.t.numpy() < INF32).sum()


def test_layout_refusals(tables):
    _, pt = tables
    o, d = _rays(n=8)
    with pytest.raises(ValueError, match="node_layout"):
        intersect_tris_bvh(_pv(o), _pv(d), pt.mesh, pt.bvh, EPS,
                           node_layout="aos16")
    # indices ride as f32 in the 10-float record: exact only below 2^24
    big = types.SimpleNamespace(mt=torch.empty(10, 4, 1).expand(
        10, 4, 1 << 24))
    with pytest.raises(ValueError, match="2\\^24"):
        intersect_tris_bvh(_pv(o), _pv(d), big, pt.bvh, EPS,
                           node_layout="aos10")
    assert MAX_LEAF_TRIS == 96


def test_bvh_mode_full_trace(tables):
    """tests/test_bvh_traverse.py's case: 12x12 camera rays with injected
    uniforms traced through ``bvh`` and through ``dense``."""
    _, pt = tables
    cfg, _ = build_preset("array_bvh", "cpu", width=12, height=12, spp=1,
                          max_depth=2, traversal="dense")
    W = H = 12
    x = np.arange(W, dtype=np.float32)
    ux = np.tile(x - W / 2 + 0.5, H)
    uy = np.repeat(H / 2 - x - 0.5, W)
    z = np.float32(-W / (2 * np.tan(np.pi / 6)))
    d = np.stack([ux, uy, np.full(W * H, z, np.float32)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.float32([0, 0, 55]), (W * H, 1))
    rng = np.random.default_rng(1234)
    un = torch.from_numpy(
        rng.random((2, 2, W * H)).astype(np.float32) * 0.998 + 1e-3)
    cd, sd = trace(pt, cfg, _pv(o), _pv(d), un)
    cb, sb = trace(pt, dataclasses.replace(cfg, traversal="bvh"), _pv(o),
                   _pv(d), un)
    a = np.stack([c.numpy() for c in cd], -1)
    b = np.stack([c.numpy() for c in cb], -1)
    bad = np.abs(a - b) > 1e-3 * np.abs(a) + 1.0
    assert bad.any(-1).mean() < 0.02
    assert (sb.hit.numpy() == W * H).all()


def test_bvh_frame_against_the_golden():
    """The 48x48 spp 2 depth 2 seed 0 frame through ``bvh`` (both layouts,
    bitwise equal) under tests/test_golden.py's bound: fewer than 0.5% of
    pixels off by more than 1e-4*|g| + 1.0."""
    cfg, tab = build_preset("array_bvh", "cpu", width=48, height=48, spp=2,
                            max_depth=2, traversal="bvh")
    img, stats = render_preset_frame(tab, cfg, seed=0)
    aos = dataclasses.replace(cfg, bvh_node_layout="aos10")
    assert np.array_equal(render_preset_frame(tab, aos, seed=0)[0], img)
    g = np.load(GOLDEN)
    bad = (np.abs(img - g) > 1e-4 * np.abs(g) + 1.0).any(-1)
    assert bad.mean() < 0.005, bad.mean()
    assert (stats.hit == 48 * 48 * 2).all()
