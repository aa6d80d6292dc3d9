"""Build, load and launch the hand-written CUDA kernels.

``csrc/pairs_trace.cu`` (B0-B3) and ``csrc/pallas_trace.cu`` (B5, B6),
which share the Moller-Trumbore test of ``csrc/mt.cuh``, are compiled by
``nvcc`` for ``sm_90a``, one process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, into ``raytracinggpu_tpu_torch/_build/`` under a name keyed by a hash
of every file in ``csrc/`` and the flags, and loaded with ctypes.
Nothing is compiled or loaded when this module is imported.

``--fmad=false`` keeps nvcc from contracting a*b+c into an FMA, so the
kernels round every product and sum as PyTorch's eager ops do and match
the plain versions in ``ops/pairs_trace.py`` and ``ops/pallas_trace.py``
bit for bit.

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
CSRC = os.path.join(_PKG, "csrc")
SOURCES = tuple(os.path.join(CSRC, f)
                for f in ("pairs_trace.cu", "pallas_trace.cu"))
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "--fmad=false",
    "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
TILE_T = 128  # triangles per tile of the tiled kernels (B5, B6)

# Each launch wrapper: (C function, field rows its kernel reads, output
# dtypes, culling input).  The C functions take (rfT, fields, culling, R,
# Tc, n, subg, tile_t, eps, *outputs, stream): for the pairs kernels the
# culling input is the (W, R/subg) bitmask and n = W, for the tiled
# kernels the (R/subg, L) list rows and n = L.
_SPECS = {
    "pairs_closest": ("rt_pairs_closest", 17, (torch.float32, torch.int32)
                      + (torch.float32,) * 3, "bits"),
    "pairs_shadow": ("rt_pairs_shadow", 17, (torch.float32,), "bits"),
    "pairs_closest_smooth": ("rt_pairs_closest_smooth", 26,
                             (torch.float32, torch.int32)
                             + (torch.float32,) * 3, "bits"),
    "pairs_closest_idx": ("rt_pairs_closest_idx", 17,
                          (torch.float32, torch.int32), "bits"),
    "pallas_closest": ("rt_pallas_closest", 16,
                       (torch.float32, torch.int32), "lists"),
    "pallas_shadow": ("rt_pallas_shadow", 16, (torch.float32,), "lists"),
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
    """Compile the kernels unless a library for these sources, headers and
    flags is already built; returns what was found and done (library path, nvcc
    version line, whether it compiled, seconds, ptxas report)."""
    srcs = []
    for name in sorted(os.listdir(CSRC)):  # the sources and their headers
        with open(os.path.join(CSRC, name), "rb") as f:
            srcs.append(name.encode() + b"\0" + f.read())
    key = hashlib.sha256(b"\0".join(srcs)
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"kernels_{key}.so")
    nvcc = find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    info = {"library": lib_path, "nvcc": nvcc,
            "nvcc_version": version.splitlines()[-1], "compiled": False,
            "seconds": 0.0, "ptxas": ""}
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        t0 = time.perf_counter()
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", o, src],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for o, src in zip(objs, SOURCES)]
        reports = []
        try:
            for p, src in zip(procs, SOURCES):
                _, err = p.communicate()
                if p.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {src} "
                                       f"({p.returncode}):\n{err}")
                reports.append(err.strip())
            res = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                                 capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                                   f"{res.stderr}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
        info.update(compiled=True, seconds=time.perf_counter() - t0,
                    ptxas="\n".join(reports))
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
        for cfun, _, dts, _ in _SPECS.values():
            fn = getattr(lib, cfun)
            fn.argtypes = [p, p, p, i, i, i, i, i, fl] + [p] * len(dts) + [p]
            fn.restype = i
        lib.rt_cuda_error_string.argtypes = [i]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(rfT, fields, cull, subg, tile_t, field_rows, kind):
    """Shapes and types of one launch; returns (R, Tc, n) with n the
    culling input's word count (bits) or row length (lists)."""
    dev = rfT.device
    for name, x, dt in (("rfT", rfT, torch.float32),
                        ("fields", fields, torch.float32),
                        (kind, cull, torch.int32)):
        if x.device != dev or x.dtype != dt or not x.is_contiguous() \
                or x.dim() != 2:
            raise ValueError(f"{name}: need a contiguous 2-D {dt} tensor on "
                             f"{dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    R, Tc = rfT.shape[1], fields.shape[1]
    if rfT.shape[0] < 9 or fields.shape[0] < field_rows:
        raise ValueError(f"rfT needs 9 feature rows and fields {field_rows} "
                         f"rows, got {rfT.shape[0]} and {fields.shape[0]}")
    if tile_t <= 0 or Tc % tile_t:
        raise ValueError(f"fields width {Tc} does not hold whole tiles of "
                         f"{tile_t}")
    n_tiles = Tc // tile_t
    if kind == "bits":
        n = cull.shape[0]
        shape_ok = cull.shape[1] == R // max(subg, 1) and n * 32 >= n_tiles
    else:
        n = cull.shape[1]
        shape_ok = cull.shape == (R // max(subg, 1), 1 + n_tiles)
    if subg <= 0 or R % subg or not shape_ok:
        raise ValueError(f"{kind} {tuple(cull.shape)} do not match R={R}, "
                         f"subg={subg} and {n_tiles} tiles")
    if max(R * rfT.shape[0], Tc * fields.shape[0], cull.numel()) >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    return R, Tc, n


def _raise_on(lib, err: int, name: str) -> None:
    if err:
        msg = lib.rt_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {err} ({msg})")


def _launch(name, rfT, fields, cull, eps_leaf, subg, tile_t):
    """Check the inputs, allocate the outputs and launch kernel ``name`` on
    PyTorch's current stream; returns the output tuple."""
    cfun, field_rows, dts, kind = _SPECS[name]
    R, Tc, n = _check(rfT, fields, cull, subg, tile_t, field_rows, kind)
    outs = tuple(torch.empty(R, dtype=dt, device=rfT.device) for dt in dts)
    if R == 0:
        return outs
    lib = load()
    with torch.cuda.device(rfT.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, cfun)(
            rfT.data_ptr(), fields.data_ptr(), cull.data_ptr(), R, Tc, n,
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


def pallas_closest(rfT, fields, lists, eps_leaf, subg):
    """B5 kernel: (t, idx) per ray over the tiles listed for its subgroup;
    see ops/pallas_trace."""
    return _launch("pallas_closest", rfT, fields, lists, eps_leaf, subg,
                   TILE_T)


def pallas_shadow(rfT, fields, lists, eps_leaf, subg):
    """B6 kernel: the nearest hit t per ray; see ops/pallas_trace."""
    return _launch("pallas_shadow", rfT, fields, lists, eps_leaf, subg,
                   TILE_T)[0]
