"""Morton codes (port of ``raytracinggpu_tpu/accel/lbvh.py::morton_codes``).

The pairs tables pack BVH clusters into tiles in Morton order of their box
centers (``ops/pairs_trace._cluster_slots``).
"""
from __future__ import annotations

import numpy as np

MORTON_BITS = 10  # per axis -> 30-bit codes


def _expand_bits(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v so consecutive bits land 3 apart."""
    v = v.astype(np.uint32)
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton_codes(points: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for (N, 3) points, quantized over their bbox."""
    mn = points.min(axis=0)
    mx = points.max(axis=0)
    ext = np.maximum(mx - mn, 1e-9)
    q = ((points - mn) / ext * (2**MORTON_BITS - 1)).astype(np.uint32)
    q = np.clip(q, 0, 2**MORTON_BITS - 1)
    return (
        (_expand_bits(q[:, 0]) << np.uint32(2))
        | (_expand_bits(q[:, 1]) << np.uint32(1))
        | _expand_bits(q[:, 2])
    )
