"""Batched ray-sphere intersection (port of
``raytracinggpu_tpu/ops/sphere.py``).

  delta = (u.(O-C))^2 - (|O-C|^2 - R^2); reject delta < 0
  t1 = u.(C-O) - sqrt(delta), t2 = u.(C-O) + sqrt(delta); reject t2 < 0
  t = t1 if t1 >= 0 else t2;  N = normalize(O + t u - C)

The reference scans objects in ascending id with a strict `<`, so the
lowest id wins ties; ``torch.argmin`` returns the first occurrence, as
``jnp.argmin`` does.

``intersect_spheres`` (the closest rays) and ``sphere_shadow`` (the
shadow rays) launch the kernel ``rt_sphere_hit`` of ``csrc/wavefront.cu``
for CUDA tensors and run the plain versions, ``sphere_hit_plain`` and
``sphere_shadow_plain``, for CPU tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.device import on_cuda
from raytracinggpu_tpu_torch.core.vec import Vec3, fma, sqrt
from raytracinggpu_tpu_torch.utils.profiling import span

INF = 1e9 + 9  # reference INF; 1e9 once rounded to float32


class SphereTable(NamedTuple):
    """SoA table of spheres; components shaped (S,)."""

    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    radius: torch.Tensor

    @staticmethod
    def from_list(spheres, device) -> "SphereTable":
        """spheres: iterable of (center(3,), radius)."""
        c = np.array([s[0] for s in spheres], dtype=np.float32)
        r = np.array([s[1] for s in spheres], dtype=np.float32)
        t = lambda a: torch.tensor(a, device=device)
        return SphereTable(t(c[:, 0]), t(c[:, 1]), t(c[:, 2]), t(r))


def sphere_hit_plain(O: Vec3, u: Vec3, tab: SphereTable):
    """Nearest sphere hit over the batch, in PyTorch ops (the contract of
    the kernel ``rt_sphere_hit``).

    Returns (t, obj_id, N): t (R,) = INF on miss; obj_id (R,) int32 = -1 on
    miss; N the unit outward normal at the hit point (miss lanes arbitrary).
    """
    C = Vec3(tab.cx[:, None], tab.cy[:, None], tab.cz[:, None])
    R2 = (tab.radius * tab.radius)[:, None]
    Ob = Vec3(O.x[None, :], O.y[None, :], O.z[None, :])
    ub = Vec3(u.x[None, :], u.y[None, :], u.z[None, :])

    oc = Ob - C  # O - C, (S, R)
    b = ub.dot(oc)  # u.(O-C)
    delta = fma(b, b, -(oc.norm2() - R2))
    sq = sqrt(torch.clamp_min(delta, 0.0))
    t1 = -b - sq  # u.(C-O) - sqrt(delta)
    t2 = -b + sq
    valid = (delta >= 0.0) & (t2 >= 0.0)
    t = torch.where(t1 < 0.0, t2, t1)
    t = torch.where(valid, t, INF)

    obj = torch.argmin(t, dim=0).to(torch.int32)  # first occurrence
    tmin = torch.amin(t, dim=0)
    hit = tmin < INF
    obj = torch.where(hit, obj, -1)

    # Normal at hit: normalize(O + t u - C[winner]); obj -1 gathers the
    # last sphere, as jnp indexing does, and is masked by callers.
    cwin = Vec3(tab.cx[obj], tab.cy[obj], tab.cz[obj])
    p = u.fma(tmin, O)
    n = p - cwin
    nn = torch.where(hit, n.norm(), 1.0)
    return tmin, obj, n / nn


def sphere_shadow_plain(O: Vec3, u: Vec3, tab: SphereTable, active=None,
                        lv2=None):
    """The shadow rays' nearest sphere distance t, and with ``active`` (R,)
    bool the pairs shadow cast's active lanes, ``active & ~(t * t <=
    lv2)``: a lane a sphere already occludes needs no mesh work (its
    occlusion cannot change).  Returns (t, active or None)."""
    t = sphere_hit_plain(O, u, tab)[0]
    if active is not None:
        active = active & ~(t * t <= lv2)
    return t, active


def intersect_spheres(O: Vec3, u: Vec3, tab: SphereTable):
    """``sphere_hit_plain`` on the rays' device: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    with span("spheres"):
        if on_cuda(O.x):
            from raytracinggpu_tpu_torch.ops import _kernels

            t, obj, N = _kernels.sphere_hit(O, u, tuple(tab))
            return t, obj, Vec3(*N)
        return sphere_hit_plain(O, u, tab)


def sphere_shadow(O: Vec3, u: Vec3, tab: SphereTable, active=None,
                  lv2=None):
    """``sphere_shadow_plain`` on the rays' device (the kernel in its
    shadow mode for CUDA tensors)."""
    with span("spheres"):
        if on_cuda(O.x):
            from raytracinggpu_tpu_torch.ops import _kernels

            return _kernels.sphere_hit(O, u, tuple(tab), full=False,
                                       active=active, lv2=lv2)
        return sphere_shadow_plain(O, u, tab, active, lv2)
