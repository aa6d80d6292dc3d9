"""Tone mapping (port of ``raytracinggpu_tpu/render/image_io.py::tonemap``).

The reference writes its PNGs after a gamma-2.2 tone map with a 255 clamp
and a raw char cast: ``byte = (char) min(pow(radiance, 1/2.2), 255.0)``.
Radiance is not rescaled: the light intensity (3e10) puts lit surfaces in
the hundreds after the power, and the clamp does the rest.
"""
from __future__ import annotations

import numpy as np


def tonemap(img) -> np.ndarray:
    """(H, W, 3) float radiance (numpy array or tensor) -> uint8 with the
    reference's gamma and clamp."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float64)
    out = np.minimum(np.power(np.maximum(img, 0.0), 1.0 / 2.2), 255.0)
    return out.astype(np.uint8)
