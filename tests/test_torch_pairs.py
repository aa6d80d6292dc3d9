"""The port's sphere and pairs mesh queries against the JAX package's
(raytracinggpu_tpu_torch/ops/sphere.py, ops/pairs_trace.py).

Inputs are made with numpy from a seed and go through both packages on
identical tables (``scene_tables_from_numpy``); the JAX pairs kernel runs
in Pallas interpret mode, as the JAX package's own tests run it, at the
production subgroup of 64 rays and block of 4096.

- ``_pair_bits`` (the culling bitmask) has no multiply-add, so it is
  bitwise equal.
- The mesh hits are held per lane: a lane agrees when hit/miss and the
  winner id agree and, where both hit, t is within rtol 1e-5; >= 99.9% of
  lanes must agree.  XLA:CPU contracts the kernel's Moller-Trumbore sums
  into FMAs while the port rounds every product (its CUDA kernel must
  equal its plain version bit for bit), so the last bits of beta, gamma
  and t differ.  The difference in t is absolute, not relative: it comes
  from the cancellation in A.Ng - O.Ng, whose size is set by the scene's
  coordinates, so on every lane where both hit t is also held within
  1e-5 * max(t, 1).  Measured worst case on these inputs: every lane
  agrees on hit/miss and id; t within 2.2e-7 relative on the camera rays,
  and within 8.1e-5 relative (7.8e-7 absolute, at t = 0.0096) on the
  scattered rays and 1.1e-5 relative (1.3e-6 absolute, at t = 0.124) on
  the depth-1 rays: one short ray each.
- B3 (``payload="smooth"``) and B0 (``payload=None``) are held by the
  same per-lane standard.  B3's normal is held where the winner ids
  agree: normalized, each component within 5e-5 absolute.  XLA:CPU fuses
  the Phong sum's products into FMAs and the port rounds each, on top of
  the barycentrics' last bits, which cancellation in beta and gamma
  magnifies on short rays.  Measured worst case on these inputs: 8.7e-6
  (camera rays), 1.13e-5 (scattered), 3.6e-6 (depth 1).
- The CUDA kernels are held bitwise against their plain versions in
  tests/test_torch_kernels.py, which runs without jax.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.rng import cosine_hemisphere as j_cosine
from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.integrator import wavefront as jwf
from raytracinggpu_tpu.ops import pairs_trace as jpt
from raytracinggpu_tpu.ops.sphere import intersect_spheres as j_spheres
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.convert import scene_tables_from_numpy
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.ops.sphere import intersect_spheres as p_spheres

torch.set_num_threads(2)

SUBG, BLK, EPS = 64, 4096, 1e-4
KINDS = ("camera", "scattered", "depth1")


@pytest.fixture(scope="module")
def scene():
    jcfg, jtab = j_build_preset("array_bvh", traversal="pairs")
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jcfg, jtab, ptab


def _rays(kind, jcfg, jtab, R=4000, seed=0):
    """(O, u) as (3, R) float32 numpy: a fan from the camera, random rays
    inside the box, or diffuse bounce rays leaving the primary hits."""
    rng = np.random.default_rng(seed)
    if kind == "scattered":
        O = rng.uniform(-25, 25, (3, R)).astype(np.float32)
    else:
        O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, R))
    d = rng.normal(size=(3, R)).astype(np.float32)
    if kind != "scattered":
        d[2] = -np.abs(d[2]) * 4.0 - 2.0  # toward the cat
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    if kind == "depth1":
        h = jax.jit(jwf.intersect_all, static_argnums=1)(
            jtab, jcfg, JV(*O), JV(*d))
        r = (1.0 - rng.random((2, R))).astype(np.float32)
        u1 = jax.jit(j_cosine)(r[0], r[1], h.N)
        O = np.stack([np.asarray(c) for c in h.P + h.N * np.float32(1e-4)])
        d = np.stack([np.asarray(c) for c in u1])
    return O.astype(np.float32), d.astype(np.float32)


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _pv(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


def _agree(ta, ia, tb, ib):
    """Fraction of lanes agreeing on hit/miss, winner id and t (rtol 1e-5
    where both hit); max of |dt| / max(t, 1) where both hit."""
    ha, hb = ta < 1e9, tb < 1e9
    both = ha & hb
    dt = np.where(both, np.abs(ta - tb), 0.0)
    same = (ha == hb) & (~ha | (ia == ib)) & (dt <= 1e-5 * np.abs(ta))
    scaled = (dt / np.maximum(np.abs(ta), 1.0)).max()
    return same.mean(), scaled


@pytest.mark.parametrize("kind", KINDS)
def test_spheres_match_jax(scene, kind):
    jcfg, jtab, ptab = scene
    O, u = _rays(kind, jcfg, jtab)
    tj, oj, Nj = jax.jit(j_spheres)(_jv(O), _jv(u), jtab.spheres)
    tp, op, Np = p_spheres(_pv(O), _pv(u), ptab.spheres)
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    hit = np.asarray(oj) >= 0
    np.testing.assert_allclose(tp.numpy()[hit], np.asarray(tj)[hit],
                               rtol=1e-6)
    for a, b in zip(Nj, Np):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_pair_bits_bitwise(scene, kind):
    jcfg, jtab, ptab = scene
    O, u = _rays(kind, jcfg, jtab, R=4096)
    rng = np.random.default_rng(3)
    cap = rng.uniform(1.0, 80.0, O.shape[1]).astype(np.float32)
    active = rng.random(O.shape[1]) < 0.7
    nc = int(jtab.pairs_mesh.tile_aabb.shape[0])
    jm = (jtab.pairs_mesh.member_aabb, jtab.pairs_mesh.member_tile)
    pm = (ptab.pairs_mesh.member_aabb, ptab.pairs_mesh.member_tile)
    for c, a in ((None, None), (cap, None), (cap, active)):
        bj = jpt._pair_bits(
            _jv(O), _jv(u), jtab.pairs_mesh.tile_aabb, nc, SUBG, BLK,
            cap=None if c is None else jnp.asarray(c),
            active=None if a is None else jnp.asarray(a), members=jm)
        bp = ppt._pair_bits(
            _pv(O), _pv(u), nc, SUBG, pm,
            cap=None if c is None else torch.from_numpy(c),
            active=None if a is None else torch.from_numpy(a))
        assert bp.dtype == torch.int32
        np.testing.assert_array_equal(bp.numpy(), np.asarray(bj))
    assert (bp.numpy() != 0).any()


@pytest.mark.parametrize("kind", KINDS)
def test_closest_matches_jax(scene, kind):
    jcfg, jtab, ptab = scene
    O, u = _rays(kind, jcfg, jtab)
    ts = np.asarray(jax.jit(j_spheres)(_jv(O), _jv(u), jtab.spheres)[0])
    hj, Nj = jpt.intersect_tris_pairs(
        _jv(O), _jv(u), jtab.pairs_mesh, EPS, cap=jnp.asarray(ts),
        interpret=True, subg=SUBG, blk=BLK, payload="geom")
    hp, Np = ppt.intersect_tris_pairs(
        _pv(O), _pv(u), ptab.pairs_mesh, EPS, cap=torch.from_numpy(ts),
        subg=SUBG, blk=BLK, payload="geom")
    ta, ia = np.asarray(hj.t), np.asarray(hj.idx)
    tb, ib = hp.t.numpy(), hp.idx.numpy()
    frac, scaled = _agree(ta, ia, tb, ib)
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    assert (tb < 1e9).sum() > 50  # the cast really hits the mesh
    miss = tb >= 1e9
    assert (ib[miss] == 0).all()
    for a, b in zip(Nj, Np):
        b = b.numpy()
        assert (b[miss] == 0).all()
        np.testing.assert_allclose(b[~miss], np.asarray(a)[~miss],
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("payload", ["smooth", None])
def test_smooth_and_idx_closest_match_jax(scene, kind, payload):
    """B3 and B0 against the JAX interpret-mode kernel with the same
    payload; B3's N normalized, on lanes whose winner ids agree."""
    jcfg, jtab, ptab = scene
    O, u = _rays(kind, jcfg, jtab)
    ts = np.asarray(jax.jit(j_spheres)(_jv(O), _jv(u), jtab.spheres)[0])
    oj = jpt.intersect_tris_pairs(
        _jv(O), _jv(u), jtab.pairs_mesh, EPS, cap=jnp.asarray(ts),
        interpret=True, subg=SUBG, blk=BLK, payload=payload)
    op = ppt.intersect_tris_pairs(
        _pv(O), _pv(u), ptab.pairs_mesh, EPS, cap=torch.from_numpy(ts),
        subg=SUBG, blk=BLK, payload=payload)
    (hj, Nj), (hp, Np) = (oj, op) if payload else ((oj, None), (op, None))
    ta, ia = np.asarray(hj.t), np.asarray(hj.idx)
    tb, ib = hp.t.numpy(), hp.idx.numpy()
    frac, scaled = _agree(ta, ia, tb, ib)
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    assert (tb < 1e9).sum() > 50
    miss = tb >= 1e9
    assert (ib[miss] == 0).all()
    if payload is None:
        return
    nj = np.stack([np.asarray(c) for c in Nj])
    npt = np.stack([c.numpy() for c in Np])
    assert (npt[:, miss] == 0).all()
    same = ~miss & (ia == ib)
    unit = lambda n: n[:, same] / np.linalg.norm(n[:, same], axis=0)
    err = np.abs(unit(nj) - unit(npt)).max()
    assert err <= 5e-5, err


@pytest.mark.parametrize("kind", ("scattered", "depth1"))
def test_shadow_matches_jax(scene, kind):
    jcfg, jtab, ptab = scene
    O, u = _rays(kind, jcfg, jtab)
    rng = np.random.default_rng(5)
    cap = rng.uniform(1.0, 60.0, O.shape[1]).astype(np.float32)
    active = rng.random(O.shape[1]) < 0.6
    tj = np.asarray(jpt.intersect_tris_pairs_shadow(
        _jv(O), _jv(u), jtab.pairs_mesh, EPS, cap=jnp.asarray(cap),
        interpret=True, subg=SUBG, blk=BLK, active=jnp.asarray(active)))
    tp = ppt.intersect_tris_pairs_shadow(
        _pv(O), _pv(u), ptab.pairs_mesh, EPS, cap=torch.from_numpy(cap),
        subg=SUBG, blk=BLK, active=torch.from_numpy(active)).numpy()
    frac, scaled = _agree(tj, np.zeros_like(tj), tp, np.zeros_like(tp))
    assert frac >= 0.999, frac
    assert scaled <= 1e-5, scaled
    # a lane whose whole subgroup is inactive does no work and returns INF
    sg_dead = np.repeat(~np.pad(active, (0, (-len(active)) % SUBG))
                        .reshape(-1, SUBG).any(axis=1), SUBG)[:len(active)]
    assert (tp[sg_dead] >= 1e9).all()
