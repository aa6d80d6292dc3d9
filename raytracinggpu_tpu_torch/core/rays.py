"""Ray batches (port of ``raytracinggpu_tpu/core/rays.py``).

``ri`` is the refraction index of the medium the ray travels in, so
nested refractive objects track which medium they are in.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from raytracinggpu_tpu_torch.core.vec import Vec3


class RayBatch(NamedTuple):
    O: Vec3  # origins
    u: Vec3  # unit directions
    ri: Any  # refraction index of the current medium, shape (R,)

    @staticmethod
    def make(O: Vec3, u: Vec3, ri=None) -> "RayBatch":
        if ri is None:
            ri = torch.ones_like(u.x)
        return RayBatch(O, u, ri)
