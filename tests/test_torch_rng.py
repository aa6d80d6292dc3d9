"""The port's threefry PRNG and sampling formulas against ``jax.random`` and
the JAX package's ``core/rng.py`` (raytracinggpu_tpu_torch/core/rng.py).

Keys, folds, uniforms and the per-(sample, row) uniforms of the render
pipeline are integer math and must be bitwise equal.  Box-Muller and the
cosine hemisphere go through log/cos/sin, whose last bits differ between
XLA's and torch's implementations (one or two ulps), so they are held to
rtol 1e-6 with an absolute floor of 1e-6 for values near zero (an ulp of
the 2*pi*r argument moves cos/sin by up to ~5e-7 there).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core import rng as jrng
from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.render.pipeline import row_uniforms as j_row_uniforms
from raytracinggpu_tpu_torch.core import rng as prng
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV

torch.set_num_threads(2)


def _words(key_t: prng.Key) -> np.ndarray:
    return np.array([int(key_t.k0), int(key_t.k1)], np.uint32)


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2**31 - 1])
def test_prngkey_fold_in_uniform_bitwise(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed, "cpu")
    np.testing.assert_array_equal(np.asarray(kj, np.uint32), _words(kt))
    for data in (0, 3, 511, 2**31 - 1):
        fj = jax.random.fold_in(kj, data)
        ft = prng.fold_in(kt, data)
        np.testing.assert_array_equal(np.asarray(fj, np.uint32), _words(ft))
        uj = jax.random.uniform(fj, (3, 2, 37), dtype=jnp.float32)
        ut = prng.uniform(ft, (3, 2, 37))
        np.testing.assert_array_equal(_bits(uj), _bits(ut.numpy()))
        oj = jrng.uniform_open0(fj, (5, 11))
        ot = prng.uniform_open0(ft, (5, 11))
        np.testing.assert_array_equal(_bits(oj), _bits(ot.numpy()))


@pytest.mark.parametrize("seed,sample,rows,W,depth", [
    (0, 0, (0, 48), 48, 2),
    (0, 5, (100, 131), 64, 5),
    (3, 1, (7, 9), 512, 1),
    (2**20 + 1, 31, (500, 512), 17, 3),
])
def test_row_uniforms_bitwise(seed, sample, rows, W, depth):
    r = np.arange(*rows, dtype=np.int32)
    kj = jax.random.fold_in(jax.random.PRNGKey(seed), sample)
    kt = prng.fold_in(prng.PRNGKey(seed, "cpu"), sample)
    uj = j_row_uniforms(kj, jnp.asarray(r), W, depth)
    ut = prng.row_uniforms(kt, torch.from_numpy(r), W, depth)
    assert tuple(ut.shape) == tuple(uj.shape) == (depth + 1, 2, len(r) * W)
    np.testing.assert_array_equal(_bits(uj), _bits(ut.numpy()))
    assert float(ut.min()) > 0.0 and float(ut.max()) <= 1.0


def _uniforms(n, seed):
    u = np.random.default_rng(seed).random((2, n)).astype(np.float32)
    return 1.0 - u  # (0, 1], like uniform_open0


def test_box_muller_jitter_close():
    r1, r2 = _uniforms(65536, 0)
    gj = jax.jit(jrng.box_muller_jitter)(r1, r2, np.float32(0.2))
    gt = prng.box_muller_jitter(torch.from_numpy(r1), torch.from_numpy(r2),
                                0.2)
    for a, b in zip(gj, gt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)


def test_cosine_hemisphere_close():
    rng = np.random.default_rng(1)
    r1, r2 = _uniforms(65536, 2)
    n = rng.normal(size=(3, 65536)).astype(np.float32)
    n /= np.linalg.norm(n, axis=0, keepdims=True)
    n[:, :64] = [[0.0], [0.6], [0.8]]  # the tangent-frame fallback branch
    dj = jax.jit(jrng.cosine_hemisphere)(r1, r2, JV(*n))
    dt = prng.cosine_hemisphere(torch.from_numpy(r1), torch.from_numpy(r2),
                                PV(*(torch.from_numpy(c.copy()) for c in n)))
    for a, b in zip(dj, dt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    # unit length and in the hemisphere around N
    d = np.stack([c.numpy() for c in dt])
    np.testing.assert_allclose(np.linalg.norm(d, axis=0), 1.0, atol=1e-5)
    assert ((d * n).sum(axis=0) >= -1e-6).all()
