"""Tone mapping and PNG output (port of
``raytracinggpu_tpu/render/image_io.py``: ``tonemap``, ``tonemap_device``,
``write_png``, stdlib or native, and its reader ``read_png``).

The reference writes its PNGs after a gamma-2.2 tone map with a 255 clamp
and a raw char cast: ``byte = (char) min(pow(radiance, 1/2.2), 255.0)``.
Radiance is not rescaled: the light intensity (3e10) puts lit surfaces in
the hundreds after the power, and the clamp does the rest.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from raytracinggpu_tpu_torch import native as native_mod


def tonemap(img) -> np.ndarray:
    """(H, W, 3) float radiance (numpy array or tensor) -> uint8 with the
    reference's gamma and clamp."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    img = np.asarray(img, np.float64)
    out = np.minimum(np.power(np.maximum(img, 0.0), 1.0 / 2.2), 255.0)
    return out.astype(np.uint8)


def tonemap_device(img: torch.Tensor) -> torch.Tensor:
    """``tonemap`` on the tensor's device: the same formula in float64,
    uint8 out, so it equals ``tonemap`` of the same image."""
    out = torch.clamp_min(img.double(), 0.0).pow(1.0 / 2.2).clamp_max(255.0)
    return out.to(torch.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray, native: bool | None = None) -> None:
    """Write an (H, W, 3) uint8 array as an 8-bit RGB PNG (filter 0, zlib
    level 6).  native: the C++ encoder (``native.resolve``: False stdlib,
    True the library or RuntimeError, None the library when it builds)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"need an (H, W, 3) image, got {rgb.shape}")
    lib = native_mod.resolve(native)
    if lib is not None:
        native_mod.write_png(lib, os.fspath(path), rgb)
        return
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit RGB PNG with filters 0 (none), 1 (Sub) and 2 (Up),
    as ``write_png`` writes them: (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, w, h = 8, b"", None, None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", payload[:10])
            if (depth, ctype) != (8, 2):
                raise ValueError(f"{path}: only 8-bit RGB PNGs are read")
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3
    img = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    p = 0
    for i in range(h):
        filt = raw[p]
        row = np.frombuffer(raw[p + 1:p + 1 + stride], np.uint8).astype(np.int32)
        if filt == 1:  # Sub
            row = row.copy()
            for j in range(3, stride):
                row[j] = (row[j] + row[j - 3]) & 0xFF
        elif filt == 2:  # Up
            row = (row + prev) & 0xFF
        elif filt != 0:
            raise NotImplementedError(f"PNG filter {filt}")
        img[i] = row.astype(np.uint8)
        prev = row
        p += 1 + stride
    return img.reshape(h, w, 3)
