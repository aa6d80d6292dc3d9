"""ctypes binding of the native host runtime (port of
``raytracinggpu_tpu/native.py``): the C++ OBJ parser, the BVH builder with
the reference's split semantics and the zlib PNG encoder of
``native/src/rt_native.cpp``.

The library is built at first use with ``g++`` and the flags of
``native/Makefile`` into ``raytracinggpu_tpu_torch/_build/``, under a name
keyed by a hash of the source, the flags, the compiler's version and this
host's CPU features (``-march=native`` builds for them), and renamed into
place atomically, so concurrent builders agree.  It never loads
``native/librt_native.so``, the JAX package's build.  Nothing is compiled
or loaded when this module is imported.

``native=`` of ``scene/obj.read_obj``, ``accel/bvh.build_bvh`` and
``render/image_io.write_png`` (``resolve``): ``False`` takes the numpy
path, ``True`` the library or a ``RuntimeError`` that carries the
compiler's message, ``None`` the library when it builds and ``RT_NATIVE``
is not ``0``, else the numpy path with one warning a process naming why.
The native results are the numpy ones bit for bit (tests/test_torch_native.py).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import warnings

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "src",
                      "rt_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")
LIBS = ("-lz",)

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

_lib = None
_error: str | None = None  # why the library could not be built or loaded
_warned = False
BUILD_INFO: dict = {}


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((ln for ln in f if ln.startswith(b"flags")), b"")
    except OSError:
        return b""


def build() -> dict:
    """Compile the library unless one for this source, these flags, this
    compiler and this CPU is already built; returns what was found and
    done (library path, compiler version line, whether it compiled,
    seconds).  Raises ``RuntimeError`` with the compiler's message."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: put it on PATH or set CXX")
    res = subprocess.run([cxx, "--version"], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"{cxx} --version failed:\n{res.stderr}")
    version = res.stdout.strip().splitlines()[0]
    with open(SOURCE, "rb") as f:
        src = f.read()
    key = hashlib.sha256(b"\0".join(
        [src, " ".join(CXX_FLAGS + LIBS).encode(), version.encode(),
         _cpu_flags()])).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"rt_native_{key}.so")
    info = {"library": lib_path, "compiler": version, "compiled": False,
            "seconds": 0.0}
    if not os.path.isfile(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp, *LIBS],
                             capture_output=True, text=True)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"building {SOURCE} failed "
                               f"({res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib_path)  # atomic: concurrent builders agree
        info.update(compiled=True, seconds=time.perf_counter() - t0)
    return info


def load() -> ctypes.CDLL:
    """Build the library if needed (see ``build``), load it once a process
    and return it; a failure is kept and raised again on every call."""
    global _lib, _error
    if _lib is not None:
        return _lib
    if _error is None:
        try:
            BUILD_INFO.update(build())
            lib = ctypes.CDLL(BUILD_INFO["library"])
        except (RuntimeError, OSError) as e:
            _error = str(e)
        else:
            _declare(lib)
            _lib = lib
            return lib
    raise RuntimeError(f"native host runtime unavailable: {_error}")


def _declare(lib) -> None:
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.rt_obj_parse.restype = p
    lib.rt_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.rt_obj_counts.restype = i64
    lib.rt_obj_counts.argtypes = [p, ctypes.c_int]
    lib.rt_obj_copy.restype = None
    lib.rt_obj_copy.argtypes = [p, _f32p, _f32p, _f32p, _i32p, _i32p, _i32p]
    lib.rt_obj_free.restype = None
    lib.rt_obj_free.argtypes = [p]
    lib.rt_bvh_build.restype = p
    lib.rt_bvh_build.argtypes = [_f32p, _f32p, _f32p, i64]
    lib.rt_bvh_n_nodes.restype = i64
    lib.rt_bvh_n_nodes.argtypes = [p]
    lib.rt_bvh_copy.restype = None
    lib.rt_bvh_copy.argtypes = [p, _i32p, _i32p, _i32p, _i32p, _i32p,
                                _f32p, _f32p, _i32p]
    lib.rt_bvh_free.restype = None
    lib.rt_bvh_free.argtypes = [p]
    lib.rt_png_write.restype = ctypes.c_int
    lib.rt_png_write.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                 ctypes.c_int32, _u8p]


def resolve(native: bool | None):
    """The library for a ``native=`` argument, or None for the numpy path:
    False -> None; True -> the library or RuntimeError; None -> the
    library when it loads and RT_NATIVE is not 0, else None with one
    warning a process naming why."""
    global _warned
    if native is False:
        return None
    if native is None and os.environ.get("RT_NATIVE", "1") == "0":
        why = "RT_NATIVE=0"
    else:
        try:
            return load()
        except RuntimeError:
            if native:
                raise
            why = _error
    if not _warned:
        _warned = True
        warnings.warn(f"native host runtime off ({why}); using the numpy "
                      "OBJ parser, BVH builder and PNG writer", stacklevel=3)
    return None


def parse_obj(lib, path: str, embed_transform: bool):
    """(vertices, normals, uvs, vtx, nrm, uv) of an OBJ, as
    ``scene/obj.read_obj`` parses them.  The library's own embedded
    transform rounds in f32; the numpy path's rounds once from f64, so the
    embedded vertices are taken from ``_embedded_vertices`` instead."""
    h = lib.rt_obj_parse(os.fsencode(path), 0)
    if not h:
        raise FileNotFoundError(path)
    try:
        count = lambda k: lib.rt_obj_counts(h, k)
        nv, nn, nu, nt = (count(k) for k in range(4))
        out = (np.empty((nv, 3), np.float32), np.empty((nn, 3), np.float32),
               np.empty((nu, 3), np.float32), np.empty((nt, 3), np.int32),
               np.empty((nt, 3), np.int32), np.empty((nt, 3), np.int32))
        lib.rt_obj_copy(h, *out)
    finally:
        lib.rt_obj_free(h)
    if embed_transform:
        out = (_embedded_vertices(path, nv),) + out[1:]
    return out


def _embedded_vertices(path: str, nv: int) -> np.ndarray:
    """The ``v`` records moved by v*0.8 + (0, -10, 0) as ``read_obj``'s
    numpy path moves them: parsed to f64, moved in f64, rounded once."""
    vs = []
    with open(path, "r", errors="replace") as f:
        for line in f:
            t = line.split()
            if t and t[0] == "v":
                vs.append((float(t[1]) * 0.8, float(t[2]) * 0.8 - 10.0,
                           float(t[3]) * 0.8))
    if len(vs) != nv:
        raise RuntimeError(f"{path}: {len(vs)} vertex records, the native "
                           f"parser read {nv}")
    return np.asarray(vs, np.float32).reshape(nv, 3)


def build_bvh(lib, A: np.ndarray, B: np.ndarray, C: np.ndarray):
    """(left, right, tri_start, tri_end, skip, mn, mx, order) of the
    reference BVH over (T, 3) corner arrays; order as int64."""
    A, B, C = (np.ascontiguousarray(a, np.float32) for a in (A, B, C))
    T = A.shape[0]
    h = lib.rt_bvh_build(A, B, C, T)
    try:
        n = lib.rt_bvh_n_nodes(h)
        ints = [np.empty(n, np.int32) for _ in range(5)]
        mn, mx = np.empty((n, 3), np.float32), np.empty((n, 3), np.float32)
        order = np.empty(T, np.int32)
        lib.rt_bvh_copy(h, *ints, mn, mx, order)
    finally:
        lib.rt_bvh_free(h)
    return (*ints, mn, mx, order.astype(np.int64))


def write_png(lib, path: str, rgb: np.ndarray) -> None:
    """Encode an (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0,
    zlib level 6, as ``render/image_io.write_png``'s numpy path)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape
    rc = lib.rt_png_write(os.fsencode(path), w, h, rgb)
    if rc != 0:
        raise OSError(f"rt_png_write({path}) failed ({rc})")
