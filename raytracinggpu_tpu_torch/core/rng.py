"""Counter-based PRNG and the reference's sampling formulas.

Port of ``raytracinggpu_tpu/core/rng.py`` plus
``render/pipeline.row_uniforms``.  The JAX package draws its uniforms from
``jax.random``'s threefry2x32 in the partitionable mode; frame parity at
the same seed needs those exact bits, so this module re-implements
threefry2x32, ``PRNGKey``, ``fold_in`` and ``uniform`` with integer tensor
math.  ``torch.Generator`` is not used: it gives different numbers.

Torch on the CPU has no uint32 left shift, so every 32-bit word is held in
an int64 tensor and masked with ``& 0xFFFFFFFF`` after each add and shift.
The same code runs unchanged on a CUDA tensor.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytracinggpu_tpu_torch.core.vec import Vec3, cos, log, sin, sqrt

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class Key(NamedTuple):
    """A threefry2x32 key, or a batch of keys: the two 32-bit key words as
    int64 tensors of one shape.  Passed down explicitly (``render_frame``
    takes one); nothing here keeps hidden generator state."""

    k0: torch.Tensor
    k1: torch.Tensor

    @property
    def shape(self):
        return self.k0.shape


def _rotl(v, d: int):
    return ((v << d) | (v >> (32 - d))) & _MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 of the counter pair (x0, x1) under the key
    (k0, k1); all operands are int64 tensors holding uint32 words and
    broadcast against each other.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def PRNGKey(seed: int, device) -> Key:
    """``jax.random.PRNGKey(seed)`` for a non-negative integer seed: the key
    words are (seed >> 32, seed & 0xFFFFFFFF)."""
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    word = lambda v: torch.tensor(v & _MASK, dtype=torch.int64, device=device)
    return Key(word(seed >> 32), word(seed))


def fold_in(key: Key, data) -> Key:
    """``jax.random.fold_in``: hash the counter (0, data) under ``key``.
    ``data`` is an int or an integer tensor; a tensor gives a batch of keys
    of its shape."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.k0.device) & _MASK
    return Key(*threefry2x32(key.k0, key.k1, torch.zeros_like(d), d))


def random_bits(key: Key, shape) -> torch.Tensor:
    """32 random bits per element of ``shape`` for each key in the batch:
    (*key.shape, *shape) int64.  Partitionable mode: element i hashes the
    counter (i >> 32, i & 0xFFFFFFFF) of its row-major index, and the two
    output words are xor-ed."""
    n = math.prod(shape)
    i = torch.arange(n, dtype=torch.int64, device=key.k0.device)
    k0, k1 = key.k0.unsqueeze(-1), key.k1.unsqueeze(-1)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & _MASK)
    return (y0 ^ y1).reshape(*key.shape, *shape)


def uniform(key: Key, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1): the top 23
    bits become the mantissa of a float in [1, 2), minus 1."""
    bits = random_bits(key, shape)
    one_two = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return one_two - 1.0


def uniform_open0(key: Key, shape) -> torch.Tensor:
    """Uniforms in (0, 1] matching curand_uniform's support, so log(r1) in
    Box-Muller is finite."""
    return 1.0 - uniform(key, shape)


def row_uniforms(key_s: Key, rows, W: int, depth: int) -> torch.Tensor:
    """Per-(sample, row) keyed uniform draws: each global row folds its own
    key, so any partition of the rows generates identical numbers.

    Returns (depth+1, 2, nr*W) float32: slot 0 is the Box-Muller jitter
    pair, slots 1..depth the diffuse-bounce pair per depth."""
    keys = fold_in(key_s, rows)                        # (nr,)
    u = uniform_open0(keys, (depth + 1, 2, W))         # (nr, D+1, 2, W)
    return u.permute(1, 2, 0, 3).reshape(depth + 1, 2, -1)


def box_muller_terms(r1, r2, sigma: float):
    """The factors of the Box-Muller jitter: (mag, cos 2 pi r2, sin 2 pi r2)
    with mag = sigma sqrt(-2 ln r1).  Where XLA fuses the jitter into a
    sum, the product mag*cos enters an FMA; ``render.pipeline.raygen`` does
    the same with these factors."""
    mag = float(sigma) * sqrt(-2.0 * log(r1))
    return mag, cos(2.0 * math.pi * r2), sin(2.0 * math.pi * r2)


def box_muller_jitter(r1, r2, sigma: float):
    """Anti-aliasing pixel jitter:
    (sigma*sqrt(-2 ln r1) cos(2 pi r2), sigma*sqrt(-2 ln r1) sin(2 pi r2))."""
    mag, c, s = box_muller_terms(r1, r2, sigma)
    return mag * c, mag * s


def tangent_frame(N: Vec3) -> tuple[Vec3, Vec3]:
    """Reference tangent construction:
    T1 = (-N.y, N.x, 0) when |N.y| != 0 and |N.x| != 0, else (-N.z, 0, N.x);
    T2 = N x T1."""
    cond = (torch.abs(N.y) != 0.0) & (torch.abs(N.x) != 0.0)
    zero = torch.zeros_like(N.x)
    t1 = Vec3(
        torch.where(cond, -N.y, -N.z),
        torch.where(cond, N.x, zero),
        torch.where(cond, zero, N.x),
    )
    t1 = t1.normalized()
    t2 = N.cross(t1)
    return t1, t2


def cosine_hemisphere(r1, r2, N: Vec3) -> Vec3:
    """Cosine-weighted hemisphere sample around N:
    x = cos(2 pi r1) sqrt(1-r2), y = sin(2 pi r1) sqrt(1-r2), z = sqrt(r2)."""
    x = cos(2.0 * math.pi * r1) * sqrt(1.0 - r2)
    y = sin(2.0 * math.pi * r1) * sqrt(1.0 - r2)
    z = sqrt(r2)
    t1, t2 = tangent_frame(N)
    return N.fma(z, t1.fma(x, t2 * y))
