"""Build, load and launch the hand-written CUDA kernels.

``csrc/pairs_trace.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``raytracinggpu_tpu_torch/_build/`` under a name keyed by a hash of the
source and the flags, and loaded with ctypes.  Nothing is compiled or
loaded when this module is imported.

``--fmad=false`` keeps nvcc from contracting a*b+c into an FMA, so the
kernels round every product and sum as PyTorch's eager ops do and match
the plain versions in ``ops/pairs_trace.py`` bit for bit.

Each launch wrapper checks its tensors, launches on PyTorch's current
stream, raises if the launch returned a CUDA error, and adds one to its
entry in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "pairs_trace.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Each launch wrapper: (C function, field rows its kernel reads, output
# dtypes).  The C functions take (rfT, fields, bits, R, Tc, W, subg,
# tile_t, eps, *outputs, stream).
_SPECS = {
    "pairs_closest": ("rt_pairs_closest", 17, (torch.float32, torch.int32)
                      + (torch.float32,) * 3),
    "pairs_shadow": ("rt_pairs_shadow", 17, (torch.float32,)),
    "pairs_closest_smooth": ("rt_pairs_closest_smooth", 26,
                             (torch.float32, torch.int32)
                             + (torch.float32,) * 3),
    "pairs_closest_idx": ("rt_pairs_closest_idx", 17,
                          (torch.float32, torch.int32)),
}

# Kernel launches since the last reset_launches(), by wrapper.
LAUNCHES = {name: 0 for name in _SPECS}

_lib = None
BUILD_INFO: dict = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def find_nvcc() -> str:
    """nvcc on PATH, else under $CUDA_HOME or the default CUDA prefix."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def build() -> dict:
    """Compile the kernels unless a library for this source and these
    flags is already built; returns what was found and done (library
    path, nvcc version line, whether it compiled, seconds, ptxas report)."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"pairs_trace_{key}.so")
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    info = {"library": lib_path, "nvcc": nvcc,
            "nvcc_version": version.splitlines()[-1], "compiled": False,
            "seconds": 0.0, "ptxas": ""}
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
        info.update(compiled=True, seconds=time.perf_counter() - t0,
                    ptxas=res.stderr.strip())
    return info


def load():
    """Build the kernels if needed (see ``build``), load the library once
    per process and return it; ``BUILD_INFO`` then holds what the build
    found and did."""
    global _lib
    if _lib is None:
        BUILD_INFO.update(build())
        lib = ctypes.CDLL(BUILD_INFO["library"])
        p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for cfun, _, dts in _SPECS.values():
            fn = getattr(lib, cfun)
            fn.argtypes = [p, p, p, i, i, i, i, i, fl] + [p] * len(dts) + [p]
            fn.restype = i
        lib.rt_cuda_error_string.argtypes = [i]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rfT, fields, bits, subg, tile_t, field_rows):
    dev = rfT.device
    for name, x, dt in (("rfT", rfT, torch.float32),
                        ("fields", fields, torch.float32),
                        ("bits", bits, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or x.dim() != 2:
            raise ValueError(f"{name}: need a contiguous 2-D {dt} tensor on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    R, Tc, W = rfT.shape[1], fields.shape[1], bits.shape[0]
    if rfT.shape[0] < 9 or fields.shape[0] < field_rows:
        raise ValueError(f"rfT needs 9 feature rows and fields {field_rows} "
                         f"rows, got {rfT.shape[0]} and {fields.shape[0]}")
    if subg <= 0 or R % subg or bits.shape[1] != R // subg:
        raise ValueError(f"bits {tuple(bits.shape)} do not match R={R}, "
                         f"subg={subg}")
    if tile_t <= 0 or Tc % tile_t or W * 32 < Tc // tile_t:
        raise ValueError(f"fields width {Tc} does not hold whole tiles of "
                         f"{tile_t} for {W} bitmask words")
    if max(R * 9, Tc * field_rows) >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    return R, Tc, W


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _launch(name, rfT, fields, bits, eps_leaf, subg, tile_t):
    """Check the inputs, allocate the outputs and launch kernel ``name`` on
    PyTorch's current stream; returns the output tuple."""
    cfun, field_rows, dts = _SPECS[name]
    R, Tc, W = _check(rfT, fields, bits, subg, tile_t, field_rows)
    outs = tuple(torch.empty(R, dtype=dt, device=rfT.device) for dt in dts)
    if R == 0:
        return outs
    lib = load()
    with torch.cuda.device(rfT.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, cfun)(
            rfT.data_ptr(), fields.data_ptr(), bits.data_ptr(), R, Tc, W,
            subg, tile_t, max(float(eps_leaf), 0.0),
            *(o.data_ptr() for o in outs), stream)
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1
    return outs


def pairs_closest(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B1 kernel: (t, idx, nx, ny, nz) per ray, N the winner's Ng; see
    ops/pairs_trace."""
    return _launch("pairs_closest", rfT, fields, bits, eps_leaf, subg, tile_t)


def pairs_closest_smooth(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B3 kernel: (t, idx, nx, ny, nz) per ray, N the winner's
    Phong-interpolated vertex normal; see ops/pairs_trace."""
    return _launch("pairs_closest_smooth", rfT, fields, bits, eps_leaf, subg,
                   tile_t)


def pairs_closest_idx(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B0 kernel: (t, idx) per ray; see ops/pairs_trace."""
    return _launch("pairs_closest_idx", rfT, fields, bits, eps_leaf, subg,
                   tile_t)


def pairs_shadow(rfT, fields, bits, eps_leaf, subg, tile_t):
    """B2 kernel: the nearest hit t per ray; see ops/pairs_trace."""
    return _launch("pairs_shadow", rfT, fields, bits, eps_leaf, subg,
                   tile_t)[0]
