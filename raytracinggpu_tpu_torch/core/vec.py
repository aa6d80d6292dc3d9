"""Structure-of-arrays 3-vector math over torch tensors.

Port of ``raytracinggpu_tpu/core/vec.py``: three ``(R,)`` component tensors
per batch, with the JAX package's rounding.

The JAX package runs on XLA, and XLA:CPU contracts every ``a*b + c`` it
emits into one fused multiply-add (as nvcc does by default for the
reference CUDA renderer).  Decisions of the renderer hang on those last
bits: a shadow ray leaving a wall sphere of radius 940 at eps 1e-4 is
self-occluded or not depending on how ``b*b - (|O-C|^2 - R^2)`` rounds,
and about one such ray in a hundred sits on that edge.  So the sums here
are rounded as XLA rounds them, through ``fma``: ``dot`` is
fma(z, z', fma(x, x', y*y')), each ``cross`` component fma(a, b, -(c*d)),
and ``Vec3.fma`` the per-component a*s + c.  ``sqrt`` is correctly rounded
(torch's vectorized CPU sqrt is not always); ``log`` is XLA:CPU's own f32
algorithm, and ``cos`` and ``sin`` are the f64 functions rounded to f32,
which agree with XLA's more often than torch's f32 ones.  The sampling of
the renderer (Box-Muller jitter, hemisphere directions) uses them.  The ray features of the
pairs kernel (``w = O x u``) are computed with this ``cross``.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


def _f64(v):
    return v.double() if torch.is_tensor(v) else float(v)


def fma(a, b, c):
    """a*b + c with one f32 rounding.  The product of two f32 values is
    exact in f64, so the f64 sum rounded to f32 is the fused result (a
    second rounding can differ only at an exact f32 midpoint)."""
    return (_f64(a) * _f64(b) + _f64(c)).float()


def sqrt(x):
    """Correctly rounded f32 square root on every device (the f64 root
    rounded to f32 is)."""
    return torch.sqrt(x.double()).float()


def cos(x):
    """f32 cosine as the f64 cosine rounded to f32: it equals XLA:CPU's f32
    cosine on 98.7% of lanes of uniform angles in [0, 2 pi), torch's f32
    cosine on 95%."""
    return torch.cos(x.double()).float()


def sin(x):
    """f32 sine, rounded as ``cos`` (98.7% and 95% of lanes)."""
    return torch.sin(x.double()).float()


# Cephes logf: polynomial of log(1+x) on [sqrt(1/2)-1, sqrt(2)-1]
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def log(x):
    """f32 natural logarithm of positive normal f32 values, computed as
    XLA:CPU computes ``jnp.log``: the Cephes logf polynomial with its
    multiply-adds fused as LLVM fuses them.  Bitwise equal to XLA:CPU's on
    200,000 uniforms in (0, 1], where torch's f32 log agrees on 86%."""
    f = lambda v: float(np.float32(v))
    p = [f(c) for c in _LOG_P]
    bits = x.contiguous().view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    small = m < f(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = (fma(fma(p[k], x, p[k + 1]), x, p[k + 2]) for k in (0, 3, 6))
    y = fma(fma(y, x3, y1), x3, y2)
    y = fma(y, x3, e * f(_LOG_Q1))
    x = fma(x2, -0.5, x) + y
    return fma(e, f(_LOG_Q2), x)


class Vec3(NamedTuple):
    """A batch of 3D vectors stored as separate component tensors."""

    x: Any
    y: Any
    z: Any

    # ---- construction -------------------------------------------------
    @staticmethod
    def zeros(shape, device, dtype=torch.float32) -> "Vec3":
        z = torch.zeros(shape, dtype=dtype, device=device)
        return Vec3(z, z, z)

    @staticmethod
    def const(vx, vy, vz, device, dtype=torch.float32) -> "Vec3":
        """0-d component tensors (scene constants: light, camera)."""
        return Vec3(*(torch.tensor(v, dtype=dtype, device=device)
                      for v in (vx, vy, vz)))

    # ---- arithmetic ---------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def __mul__(self, o):
        """Scalar/tensor broadcast multiply, or elementwise Vec3*Vec3."""
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, s):
        return Vec3(self.x / s, self.y / s, self.z / s)

    def fma(self, s, c: "Vec3") -> "Vec3":
        """self*s + c, one rounding per component (s a scalar, a tensor
        or a Vec3)."""
        s = s if isinstance(s, Vec3) else (s, s, s)
        return Vec3(*(fma(a, b, d) for a, b, d in zip(self, s, c)))

    # ---- geometry -----------------------------------------------------
    def dot(self, o: "Vec3"):
        return fma(self.z, o.z, fma(self.x, o.x, self.y * o.y))

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            fma(self.y, o.z, -(self.z * o.y)),
            fma(self.z, o.x, -(self.x * o.z)),
            fma(self.x, o.y, -(self.y * o.x)),
        )

    def norm2(self):
        return self.dot(self)

    def norm(self):
        return sqrt(self.norm2())

    def normalized(self) -> "Vec3":
        return self / self.norm()


def vwhere(mask, a: Vec3, b: Vec3) -> Vec3:
    """Per-lane select between two Vec3 batches."""
    return Vec3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def vgather(v: Vec3, idx) -> Vec3:
    """Gather components of a Vec3 table by integer index tensor."""
    return Vec3(v.x[idx], v.y[idx], v.z[idx])
