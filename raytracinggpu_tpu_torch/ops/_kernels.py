"""Build, load and launch the hand-written CUDA kernels.

``csrc/pairs_trace.cu`` (B0-B3), ``csrc/pallas_trace.cu`` (B5, B6) and
``csrc/micro_kernel.cu`` (the probes B7a-e), which share the
Moller-Trumbore test of ``csrc/mt.cuh`` (and B0-B3, B5, B6 and B7e the
staging of ``csrc/stage.cuh``), ``csrc/cull.cu`` (the culling:
``pair_bits``, ``compact_key`` and ``compact_bits`` (a compacted cast's
rows and culling in one launch) of the pairs traversal, ``tile_lists`` of
the tiled one), ``csrc/wavefront.cu`` (the depth step's per-lane math:
``sphere_hit``, ``shade``, ``bounce``, and the primary rays,
``primary_rays``; and ``f32_identities``, the check of the identities
``sphere_hit``'s loop rests on) and ``csrc/glue.cu`` (the mesh casts' glue:
``ray_rows``, ``scatter``; the trace's backward ``composite``) are
compiled by ``nvcc`` for
``sm_90a``, one process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, into ``raytracinggpu_tpu_torch/_build/`` under a name keyed by a hash
of every file in ``csrc/`` and the flags, and loaded with ctypes.
Nothing is compiled or loaded when this module is imported.

``--fmad=false`` keeps nvcc from contracting a*b+c into an FMA, so the
kernels round every product and sum as PyTorch's eager ops do and match
the plain versions in ``ops/pairs_trace.py``, ``ops/pallas_trace.py``,
``bench/micro_kernel.py``, ``ops/sphere.py``, ``integrator/wavefront.py``
and ``render/pipeline.py`` bit for bit.

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
                for f in ("pairs_trace.cu", "pallas_trace.cu",
                          "micro_kernel.cu", "cull.cu", "wavefront.cu",
                          "glue.cu"))
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

# The probes of csrc/micro_kernel.cu (B7a-e), each with a C signature of
# its own (see the probe_* wrappers below).
PROBES = ("probe_tile_slope", "probe_block_mask", "probe_uniform_branch",
          "probe_row_gather", "probe_pair_slope")
PROBE_BLK = 1024  # rays per block of B7b and B7e
PROBE_SUBG = 64   # rays per subgroup of B7a and B7c
PROBE_FIXED = 8   # tiles of B7c

# The culling kernels of csrc/cull.cu (see pair_bits, compact_key,
# tile_lists and compact_bits).
CULLING = ("pair_bits", "compact_key", "tile_lists", "compact_bits")

# The depth step's kernels and the primary rays' of csrc/wavefront.cu (see
# sphere_hit, shade, bounce and primary_rays).
DEPTH_STEP = ("sphere_hit", "shade", "bounce", "primary_rays")

# What rt_f32_identities counts (csrc/wavefront.cu, in order; see
# f32_identities)
IDENTITY_COUNTS = ("patterns", "sqrt_differs", "doubles", "accepted",
                   "round_differs", "narrow_differs", "rejected_normal")

# The mesh casts' glue and the trace's backward composite of csrc/glue.cu
# (see ray_rows, scatter and composite).
GLUE = ("ray_rows", "scatter", "composite")
COMPOSITE_DEPTHS = 8  # depths one rt_composite launch takes (kMaxDepths)
SCATTER_OUTPUTS = 5   # outputs one rt_scatter launch takes (kMaxOut)

# Kernel launches since the last reset_launches(), by wrapper.
LAUNCHES = {name: 0 for name in (*_SPECS, *PROBES, *CULLING, *DEPTH_STEP,
                                 *GLUE)}

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
        for cfun, args in (
                ("rt_probe_tile_slope", [p, p, p, i, i, i, i, p, p]),
                ("rt_probe_uniform_branch", [p, p, p, i, i, i, i, i, p, p]),
                ("rt_probe_block_mask", [p, i, p, p]),
                ("rt_probe_block_mask_control", [p, i, p, p]),
                ("rt_probe_row_gather", [p, p, i, i, p, p]),
                ("rt_probe_pair_slope", [p, p, p, i, i, i, i, p, p]),
                ("rt_pair_bits", [p] * 7 + [i, p, i, p, p, i, i, i, p, p]),
                ("rt_compact_key", [p] * 7 + [i] * 4 + [p, p, i, i, p, p,
                                                         p]),
                # the same with the rays a thread forced (the last int)
                ("rt_pair_bits_k", [p] * 7 + [i, p, i, p, p, i, i, i, p, i,
                                              p]),
                ("rt_compact_key_k", [p] * 7 + [i] * 4 + [p, p, i, i, p, p,
                                                           i, p]),
                ("rt_tile_lists", [p] * 7 + [i, p, i, i, i, p, p, p]),
                ("rt_tile_lists_k", [p] * 7 + [i, p, i, i, i, p, p, i, p]),
                # rays a thread, one launch or two
                ("rt_tile_lists_ko", [p] * 7 + [i, p, i, i, i, p, p, i, i,
                                                p]),
                # an array of pointers, then scalars (rays a thread last)
                ("rt_compact_bits", [p] + [i] * 7 + [p]),
                ("rt_compact_bits_k", [p] + [i] * 8 + [p]),
                # csrc/wavefront.cu: an array of pointers, then scalars
                ("rt_sphere_hit", [p, i, i, i, p]),
                ("rt_f32_identities", [ctypes.c_ulonglong,
                                       ctypes.c_ulonglong, p, i, p]),
                ("rt_shade", [p, i, i, fl, p]),
                ("rt_bounce", [p, i, p]),
                ("rt_primary_rays", [p, i, ctypes.c_uint, i, i, i,
                                     ctypes.c_longlong, fl, fl, fl, fl, p]),
                # csrc/glue.cu likewise
                ("rt_ray_rows", [p, i, i, i, p]),
                ("rt_scatter", [p, p, i, i, i, i, p]),
                ("rt_composite", [p, i, i, i, p]),
                ("rt_composite_max_depths", [])):
            fn = getattr(lib, cfun)
            fn.argtypes = args
            fn.restype = i
        lib.rt_tile_lists_scratch.argtypes = [i] * 5
        lib.rt_tile_lists_scratch.restype = ctypes.c_longlong
        lib.rt_cuda_error_string.argtypes = [i]
        lib.rt_cuda_error_string.restype = ctypes.c_char_p
        if lib.rt_composite_max_depths() != COMPOSITE_DEPTHS:
            raise RuntimeError("csrc/glue.cu's kMaxDepths is not "
                               f"COMPOSITE_DEPTHS ({COMPOSITE_DEPTHS})")
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
    if kind == "bits" and tile_t % 32:
        raise ValueError(f"the pairs kernels stage tiles in pieces of 32 "
                         f"slots: tile width {tile_t} is not a multiple of 32")
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


# ------------------------------------------------ the probes (B7a-e)

def _need(name, x, dtype, cols=None):
    """One probe input: a contiguous 2-D tensor of ``dtype`` (with ``cols``
    columns when given)."""
    if not (x.dtype == dtype and x.dim() == 2 and x.is_contiguous()
            and (cols is None or x.shape[1] == cols)):
        raise ValueError(
            f"{name}: need a contiguous 2-D {dtype} tensor"
            + (f" with {cols} columns" if cols else "")
            + f", got {x.dtype} {tuple(x.shape)}")
    if x.numel() >= 2**31:
        raise ValueError(f"{name}: kernel indices are 32-bit: too large")


def _on_card(*tensors):
    """The probe, culling and depth-step kernels take tensors of one CUDA
    device (a CPU tensor's place is the plain version beside the
    dispatching function)."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(x.device != dev for x in tensors):
        raise ValueError("these kernels need their tensors on one CUDA "
                         f"device, got {[str(x.device) for x in tensors]}")


def _check_cast(rows, rf, tri, group):
    """Inputs of B7a, B7c, B7e: rf (R, 16) and tri (16, n * 128) f32 and
    one int32 row of ``rows`` per ``group`` rays; returns (R, Tp)."""
    _need("rf", rf, torch.float32, 16)
    _need("tri", tri, torch.float32)
    _need("rows", rows, torch.int32)
    R, Tp = rf.shape[0], tri.shape[1]
    if tri.shape[0] != 16 or Tp % TILE_T:
        raise ValueError(f"tri {tuple(tri.shape)} is not 16 rows of whole "
                         f"{TILE_T}-triangle tiles")
    if group <= 0 or R == 0 or R % TILE_T or R % group \
            or rows.shape[0] != R // group or rows.shape[1] < 1:
        raise ValueError(f"rows {tuple(rows.shape)} do not give one row per "
                         f"{group} of {R} rays, or R is not a multiple of "
                         f"{TILE_T}")
    return R, Tp


def _run(name, dev, call):
    """Launch one probe kernel on PyTorch's current stream of ``dev``:
    ``call(lib, stream)`` returns the launch's CUDA error."""
    lib = load()
    with torch.cuda.device(dev):
        err = call(lib, torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, name)
    LAUNCHES[name] += 1


def probe_tile_slope(lists, rf, tri):
    """B7a kernel: t (R / 128, 128), per ray the min of the MT pass over
    the tiles listed for its 64-ray subgroup; see bench/micro_kernel."""
    R, Tp = _check_cast(lists, rf, tri, PROBE_SUBG)
    _on_card(lists, rf, tri)
    t = torch.empty((R // TILE_T, TILE_T), dtype=torch.float32,
                    device=rf.device)
    _run("probe_tile_slope", rf.device,
         lambda lib, st: lib.rt_probe_tile_slope(
             lists.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp,
             lists.shape[1], PROBE_SUBG, t.data_ptr(), st))
    return t


def probe_uniform_branch(mask, rf, tri):
    """B7c kernel: as B7a over the first 8 tiles, tile j visited iff
    mask[subgroup, j] > 0; see bench/micro_kernel."""
    R, Tp = _check_cast(mask, rf, tri, PROBE_SUBG)
    if PROBE_FIXED > min(mask.shape[1], Tp // TILE_T):
        raise ValueError(f"{PROBE_FIXED} fixed tiles pass the mask's "
                         f"{mask.shape[1]} columns or the {Tp // TILE_T} "
                         "tiles")
    _on_card(mask, rf, tri)
    t = torch.empty((R // TILE_T, TILE_T), dtype=torch.float32,
                    device=rf.device)
    _run("probe_uniform_branch", rf.device,
         lambda lib, st: lib.rt_probe_uniform_branch(
             mask.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp,
             mask.shape[1], PROBE_SUBG, PROBE_FIXED, t.data_ptr(), st))
    return t


def probe_block_mask(x, mask=True):
    """B7b kernel: 2 x, each 1024-row block first computing a (32, 16)
    mask into shared memory and bounding a loop with two of its words;
    ``mask=False`` launches the control kernel, 2 x alone."""
    _need("x", x, torch.float32, 16)
    R = x.shape[0]
    if R == 0 or R % PROBE_BLK:
        raise ValueError(f"x has {R} rows, not whole blocks of {PROBE_BLK}")
    _on_card(x)
    out = torch.empty_like(x)
    cfun = "rt_probe_block_mask" if mask else "rt_probe_block_mask_control"
    _run("probe_block_mask", x.device, lambda lib, st: getattr(lib, cfun)(
        x.data_ptr(), R, out.data_ptr(), st))
    return out


def probe_row_gather(idx, table):
    """B7d kernel: out[i, :] = table[idx[i, 0], :] for a (n, 128) f32
    table; the indices must lie in [0, n) (the kernel clamps one that does
    not, the plain version raises)."""
    _need("idx", idx, torch.int32, 1)
    _need("table", table, torch.float32, TILE_T)
    R = idx.shape[0]
    if table.shape[0] == 0 or R * TILE_T >= 2**31:
        raise ValueError("the table is empty, or idx has too many rows for "
                         "the kernel's 32-bit indices")
    _on_card(idx, table)
    out = torch.empty((R, TILE_T), dtype=torch.float32, device=table.device)
    if R:
        _run("probe_row_gather", table.device,
             lambda lib, st: lib.rt_probe_row_gather(
                 idx.data_ptr(), table.data_ptr(), R, table.shape[0],
                 out.data_ptr(), st))
    return out


def probe_pair_slope(pairs, rf, tri, subg):
    """B7e kernel: t (R / 128, 128), per ray the min of the MT pass over
    the (subgroup, tile) pairs of its 1024-ray block's flat list that name
    its subgroup; see bench/micro_kernel."""
    R, Tp = _check_cast(pairs, rf, tri, PROBE_BLK)
    if subg <= 0 or PROBE_BLK % subg or Tp // TILE_T > 256:
        raise ValueError(f"subgroup {subg} does not divide {PROBE_BLK}, or "
                         f"{Tp // TILE_T} tiles pass the 256 a pair can name")
    _on_card(pairs, rf, tri)
    t = torch.empty((R // TILE_T, TILE_T), dtype=torch.float32,
                    device=rf.device)
    _run("probe_pair_slope", rf.device,
         lambda lib, st: lib.rt_probe_pair_slope(
             pairs.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp,
             pairs.shape[1], subg, t.data_ptr(), st))
    return t


# ------------------------------------------------ the culling (cull.cu)

def _ray_rows(O, u, cap, active):
    """The culling kernels' per-ray inputs, each (R,) and contiguous (the
    rows of a compacted cast's gathered ray rows are): the six f32 rows of
    O and u, cap (f32) and active (bool) or None; returns (rows, cap,
    active, R)."""
    rows = (*O, *u)
    R = rows[0].shape[0]
    for name, x, dt in (*zip(("O.x", "O.y", "O.z", "u.x", "u.y", "u.z"),
                             rows, (torch.float32,) * 6),
                        ("cap", cap, torch.float32),
                        ("active", active, torch.bool)):
        if x is not None and (x.dtype != dt or x.shape != (R,)):
            raise ValueError(f"{name}: need a ({R},) {dt} tensor, got "
                             f"{x.dtype} {tuple(x.shape)}")
    if R >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    c = lambda x: None if x is None else x.contiguous()
    return tuple(x.contiguous() for x in rows), c(cap), c(active), R


def _boxes(name, boxes):
    """(nb, >= 6) f32 box rows [lo.xyz, hi.xyz, ...]."""
    _need(name, boxes, torch.float32)
    if boxes.shape[1] < 6:
        raise ValueError(f"{name}: need at least 6 columns (lo, hi), got "
                         f"{tuple(boxes.shape)}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _members(members):
    """Member boxes (nm, >= 6) f32 and member_tile (nm,) int32."""
    boxes, member_tile = members
    _boxes("member boxes", boxes)
    if member_tile.dtype != torch.int32 or member_tile.shape != (
            boxes.shape[0],) or not member_tile.is_contiguous():
        raise ValueError(f"member_tile: need a contiguous ({boxes.shape[0]},)"
                         f" int32 tensor, got {member_tile.dtype} "
                         f"{tuple(member_tile.shape)}")
    return boxes, member_tile


def pair_bits(O, u, nc, subg, members, cap=None, active=None):
    """Culling kernel (rt_pair_bits): the (W, R/subg) int32 active-tile
    bitmask of ``ops/pairs_trace.pair_bits_plain``, W = ceil(nc / 32);
    members = (member boxes (nm, 8) f32, member_tile (nm,) int32)."""
    rows, cap, active, R = _ray_rows(O, u, cap, active)
    boxes, member_tile = _members(members)
    if subg <= 0 or R % subg or nc < 0:
        raise ValueError(f"subgroup {subg} does not divide the {R} rays, or "
                         f"nc {nc} < 0")
    _on_card(*rows, boxes, member_tile,
             *(x for x in (cap, active) if x is not None))
    W, S = -(-nc // 32), R // subg
    if W * S >= 2**31:
        raise ValueError("kernel indices are 32-bit: bitmask too large")
    bits = torch.empty((W, S), dtype=torch.int32, device=rows[0].device)
    if bits.numel():
        _run("pair_bits", bits.device, lambda lib, st: lib.rt_pair_bits(
            *(x.data_ptr() for x in rows), boxes.data_ptr(), boxes.shape[1],
            member_tile.data_ptr(), boxes.shape[0], _ptr(cap), _ptr(active),
            R, subg, nc, bits.data_ptr(), st))
    return bits


def compact_key(O, u, aabb, nc, mode, shift, cap, active, valid_n):
    """Culling kernel (rt_compact_key): the ladder's (skey (R,) int32,
    n_act 0-d int64) of ``ops/pairs_trace.compact_key_plain`` over the nc
    key boxes ``aabb``, for the (mode, shift) of ``_key_mode``."""
    rows, cap, active, R = _ray_rows(O, u, cap, active)
    _boxes("key boxes", aabb)
    if aabb.shape[0] != nc or mode not in (0, 1, 2) \
            or not 0 <= shift <= 31:
        raise ValueError(f"need nc ({nc}) key boxes, got "
                         f"{aabb.shape[0]}, or key mode {mode} / shift "
                         f"{shift} out of range")
    _on_card(*rows, aabb, *(x for x in (cap, active) if x is not None))
    dev = rows[0].device
    skey = torch.empty(R, dtype=torch.int32, device=dev)
    n_act = torch.empty((), dtype=torch.int64, device=dev)
    if not R:
        return skey, n_act.zero_()
    _run("compact_key", dev, lambda lib, st: lib.rt_compact_key(
        *(x.data_ptr() for x in rows), aabb.data_ptr(), aabb.shape[1], nc,
        mode, shift, _ptr(cap), _ptr(active), R,
        max(min(int(valid_n), R), 0), skey.data_ptr(), n_act.data_ptr(), st))
    return skey, n_act


def tile_lists(O, u, aabb, n_tiles, cap, subg):
    """Culling kernel (rt_tile_lists): the (R/subg, 1 + n_tiles) int32 list
    rows of ``ops/pallas_trace.block_active_tiles_plain`` over the first
    n_tiles boxes of ``aabb`` (n, >= 6) f32, in one launch where one pass
    of a block's shared words holds its subgroups' words; else in two,
    with a (W, R/subg) int32 bitmask as scratch, W = ceil(n_tiles / 32)."""
    rows, cap, _, R = _ray_rows(O, u, cap, None)
    _boxes("tile boxes", aabb)
    if n_tiles < 1 or aabb.shape[0] < n_tiles:
        raise ValueError(f"need 1 <= n_tiles ({n_tiles}) <= the "
                         f"{aabb.shape[0]} tile boxes")
    if subg <= 0 or R % subg:
        raise ValueError(f"subgroup {subg} does not divide the {R} rays")
    _on_card(*rows, aabb, *(x for x in (cap,) if x is not None))
    W, S = -(-n_tiles // 32), R // subg
    if max(W * S, S * (1 + n_tiles)) >= 2**31:
        raise ValueError("kernel indices are 32-bit: lists too large")
    dev = rows[0].device
    lists = torch.empty((S, 1 + n_tiles), dtype=torch.int32, device=dev)
    if S:
        lib = load()
        n = lib.rt_tile_lists_scratch(R, subg, n_tiles, 0, 1)
        bits = torch.empty(n, dtype=torch.int32, device=dev) if n else None
        _run("tile_lists", dev, lambda lib, st: lib.rt_tile_lists(
            *(x.data_ptr() for x in rows), aabb.data_ptr(), aabb.shape[1],
            _ptr(cap), R, subg, n_tiles, _ptr(bits), lists.data_ptr(), st))
    return lists


# ------------------------------- the depth step and the primary rays
# (csrc/wavefront.cu; each C function takes an array of device pointers)

def _lanes(R, dev, *named):
    """Per-lane tensors of one launch: each (name, tensor, dtype) a
    contiguous (R,) tensor on ``dev``; a None tensor is passed as null."""
    if R >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    for name, x, dt in named:
        if x is not None and (x.dtype != dt or x.shape != (R,)
                              or not x.is_contiguous() or x.device != dev):
            raise ValueError(f"{name}: need a contiguous ({R},) {dt} tensor "
                             f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")


def _table(dev, *named):
    """Scene constants: each (name, tensor, dtype, shape) a contiguous
    tensor of that shape on ``dev`` (() a 0-d tensor; None: any non-empty
    1-D tensor)."""
    for name, x, dt, shape in named:
        if x.dtype != dt or x.device != dev or not x.is_contiguous() or (
                x.dim() != 1 or not x.numel() if shape is None
                else x.shape != shape):
            want = "(n,)" if shape is None else shape
            raise ValueError(f"{name}: need a contiguous {dt} tensor of "
                             f"shape {want} on {dev}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")


def _rows3(name, x, R, dev):
    """A (3, R) f32 tensor whose rows the kernel reads or writes."""
    if x.dtype != torch.float32 or x.shape != (3, R) \
            or not x.is_contiguous() or x.device != dev:
        raise ValueError(f"{name}: need a contiguous (3, {R}) float32 tensor "
                         f"on {dev}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    return tuple(x[c] for c in range(3))


def _counts(counts, dev):
    if counts.dtype != torch.int64 or counts.shape != (6,) \
            or not counts.is_contiguous() or counts.device != dev:
        raise ValueError(f"counts: need a contiguous (6,) int64 tensor on "
                         f"{dev}, got {counts.dtype} {tuple(counts.shape)} on "
                         f"{counts.device}")


def _pointers(*xs):
    return (ctypes.c_void_p * len(xs))(*(_ptr(x) for x in xs))


def sphere_hit(O, u, spheres, full=True, active=None, lv2=None):
    """Kernel rt_sphere_hit: the nearest sphere of each ray of
    ``ops/sphere.sphere_hit_plain``.  full: (t, obj, (Nx, Ny, Nz)); else
    (t, active & ~(t * t <= lv2)) of ``sphere_shadow_plain``, the second
    None without ``active``.  spheres = (cx, cy, cz, radius), (S,) f32."""
    dev, R = O[0].device, O[0].shape[0]
    _lanes(R, dev, *zip(("O.x", "O.y", "O.z", "u.x", "u.y", "u.z"), (*O, *u),
                        (torch.float32,) * 6))
    S = spheres[0].shape[0] if spheres[0].dim() == 1 else 0
    _table(dev, *((n, x, torch.float32, (S,)) for n, x in zip(
        ("cx", "cy", "cz", "radius"), spheres)))
    if S < 1 or full and active is not None or (active is None) != (
            lv2 is None):
        raise ValueError(f"need at least one sphere (got {S}), and active "
                         "with lv2 in the shadow mode only")
    _lanes(R, dev, ("active", active, torch.bool),
           ("lv2", lv2, torch.float32))
    _on_card(O[0])
    new = lambda dt=torch.float32: torch.empty(R, dtype=dt, device=dev)
    t = new()
    obj = new(torch.int32) if full else None
    N = (new(), new(), new()) if full else (None,) * 3
    act = None if active is None else new(torch.bool)
    if R:
        ptrs = _pointers(*O, *u, *spheres, active, lv2, t, obj, *N, act)
        _run("sphere_hit", dev, lambda lib, st: lib.rt_sphere_hit(
            ptrs, R, S, int(full), st))
    return (t, obj, N) if full else (t, act)


def f32_identities(first: int = 0, n: int = 2**32, device="cuda") -> dict:
    """Kernel rt_f32_identities on ``device``: the identities of
    rt_sphere_hit's sphere loop over the f32 bit patterns first, ...,
    first + n - 1 (modulo 2^32): {name: count} for ``IDENTITY_COUNTS``
    (``sqrt_differs``, ``round_differs`` and ``narrow_differs`` are faults;
    ``rejected_normal`` counts doubles the loop sends to its exact path
    though the fast one was right).  A check, not a stage of the main path:
    not counted in LAUNCHES."""
    dev = torch.device(device)
    if dev.type != "cuda" or not (0 <= first < 2**32 and 0 <= n <= 2**32):
        raise ValueError("f32_identities: need a CUDA device, first in "
                         "[0, 2^32) and n in [0, 2^32]")
    counts = torch.zeros(len(IDENTITY_COUNTS), dtype=torch.int64, device=dev)
    lib = load()
    with torch.cuda.device(dev):
        err = lib.rt_f32_identities(first, n, counts.data_ptr(),
                                    len(IDENTITY_COUNTS),
                                    torch.cuda.current_stream().cuda_stream)
    _raise_on(lib, err, "f32_identities")
    return dict(zip(IDENTITY_COUNTS, counts.tolist()))


def shade(O, u, ri, sph, mesh, mats, L, intensity, eps, mesh_id, counts):
    """Kernel rt_shade: the outputs of ``integrator/wavefront.shade_plain``
    in the order of its ``Shade`` (the albedo a (3, R) tensor), adding the
    hit, mirror, refract, tir and diffuse lanes into counts[:5].
    sph = (t, obj, N) of sphere_hit on these rays; mesh = (t, N
    unnormalised) of the mesh's closest cast, or None; mats = (albedo
    (3 x (M,)), mirror, in_ri, out_ri); L three 0-d f32 tensors and
    intensity one."""
    dev, R = O[0].device, O[0].shape[0]
    t_s, obj_s, N_s = sph
    t_m, N_m = mesh if mesh is not None else (None, (None,) * 3)
    f32 = torch.float32
    _lanes(R, dev, *zip(("O.x", "O.y", "O.z", "u.x", "u.y", "u.z", "ri",
                         "t_s", "N_s.x", "N_s.y", "N_s.z", "t_m", "N_m.x",
                         "N_m.y", "N_m.z"),
                        (*O, *u, ri, t_s, *N_s, t_m, *N_m), (f32,) * 15),
           ("obj", obj_s, torch.int32))
    albedo, mirror, in_ri, out_ri = mats
    M = mirror.shape[0] if mirror.dim() == 1 else 0
    _table(dev, *((f"albedo.{c}", x, f32, (M,))
                  for c, x in zip("xyz", albedo)),
           ("mirror", mirror, torch.bool, (M,)), ("in_ri", in_ri, f32, (M,)),
           ("out_ri", out_ri, f32, (M,)),
           *((f"L.{c}", x, f32, ()) for c, x in zip("xyz", L)),
           ("intensity", intensity, f32, ()))
    _counts(counts, dev)
    if M < 1 or (mesh is not None and not 0 <= mesh_id < M):
        raise ValueError(f"{M} materials and mesh id {mesh_id}: need at "
                         "least one, and the mesh's among them")
    _on_card(O[0])
    new = lambda dt=f32: torch.empty(R, dtype=dt, device=dev)
    v3 = lambda: tuple(new() for _ in range(3))
    O2, u2, ri2, S, d = v3(), v3(), new(), v3(), v3()
    cap, lv2, N = new(), new(), v3()
    alb = torch.empty((3, R), dtype=f32, device=dev)
    lum, is_diff, sh_active = new(), new(torch.bool), new(torch.bool)
    if R:
        ptrs = _pointers(*O, *u, ri, t_s, obj_s, *N_s, t_m, *N_m, *albedo,
                         mirror, in_ri, out_ri, *L, intensity, *O2, *u2, ri2,
                         *S, *d, cap, lv2, *N, *_rows3("alb", alb, R, dev),
                         lum, is_diff, sh_active, counts)
        _run("shade", dev, lambda lib, st: lib.rt_shade(
            ptrs, R, int(mesh_id), float(eps), st))
    return O2, u2, ri2, S, d, cap, lv2, N, alb, lum, is_diff, sh_active


def bounce(u2, N, alb, lum, lv2, is_diff, sh_active, t_sph, t_mesh, r1, r2,
           counts):
    """Kernel rt_bounce: (u3, direct (3, R)) of
    ``integrator/wavefront.bounce_plain``, adding the shadowed lanes into
    counts[5].  t_mesh None: the shadow distance is t_sph alone."""
    dev, R = u2[0].device, u2[0].shape[0]
    f32 = torch.float32
    _lanes(R, dev, *zip(("u2.x", "u2.y", "u2.z", "N.x", "N.y", "N.z", "lum",
                         "lv2", "t_sph", "t_mesh", "r1", "r2"),
                        (*u2, *N, lum, lv2, t_sph, t_mesh, r1, r2),
                        (f32,) * 12),
           ("is_diff", is_diff, torch.bool),
           ("sh_active", sh_active, torch.bool))
    alb_rows = _rows3("alb", alb, R, dev)
    _counts(counts, dev)
    _on_card(u2[0])
    u3 = tuple(torch.empty(R, dtype=f32, device=dev) for _ in range(3))
    direct = torch.empty((3, R), dtype=f32, device=dev)
    if R:
        ptrs = _pointers(*u2, *N, *alb_rows, lum, lv2, is_diff, sh_active,
                         t_sph, t_mesh, r1, r2, *u3,
                         *_rows3("direct", direct, R, dev), counts)
        _run("bounce", dev, lambda lib, st: lib.rt_bounce(ptrs, R, st))
    return u3, direct


def primary_rays(key, sample, rows, cam, W, D, quirk, sigma, half_w, half_h,
                 z, O, u, un):
    """Kernel rt_primary_rays: one sample's primary rays and uniforms of
    ``render/pipeline.primary_rays_plain``, written into O and u (three
    contiguous (nr * W,) f32 views each) and un, a (D, 2, nr * W) f32 view
    with unit stride along its last dimension (depths 1..D of
    row_uniforms).  key = (k0, k1) 0-d int64, rows (nr,) int64, cam the
    camera's 12 0-d f32 components (C, bx, by, bz); sigma, half_w, half_h
    and z are f32 values (Python floats)."""
    dev = rows.device
    R = rows.shape[0] * W if rows.dim() == 1 else -1
    f32 = torch.float32
    _table(dev, ("k0", key[0], torch.int64, ()),
           ("k1", key[1], torch.int64, ()), ("rows", rows, torch.int64, None),
           *((f"camera[{i}]", x, f32, ()) for i, x in enumerate(cam)))
    _lanes(R, dev, *zip(("O.x", "O.y", "O.z", "u.x", "u.y", "u.z"),
                        (*O, *u), (f32,) * 6))
    if W < 1 or D < 0 or not 0 <= sample < 2**32 or len(cam) != 12 \
            or un.dtype != f32 or un.device != dev \
            or un.shape != (D, 2, R) or (D and (
                un.stride(2) != 1 or un.stride(0) != 2 * un.stride(1))):
        raise ValueError(f"need W >= 1, D >= 0, a sample id in [0, 2^32), "
                         f"12 camera components and un a ({D}, 2, {R}) f32 "
                         f"view of unit last stride on {dev}; got W {W}, D "
                         f"{D}, sample {sample}, {len(cam)} components, un "
                         f"{un.dtype} {tuple(un.shape)} {un.stride()} on "
                         f"{un.device}")
    _on_card(rows)
    if R:
        ptrs = _pointers(*key, rows, *cam, *O, *u, un if D else None)
        _run("primary_rays", dev, lambda lib, st: lib.rt_primary_rays(
            ptrs, R, int(sample), int(W), int(D), int(bool(quirk)),
            un.stride(1) if D else 0, float(sigma), float(half_w),
            float(half_h), float(z), st))


# ------------------------------ the mesh casts' glue and the composite
# (csrc/glue.cu; each C function takes an array of device pointers)

RAY_ROW_LAYOUTS = ("pairs", "live", "pallas")


def ray_row_count(cap, active, layout: str) -> int:
    """Rows of a cast's ray-feature rows: 16 in the ``pairs`` and
    ``pallas`` layouts, 9 and the extras (cap; with active, two) in the
    ``live`` one; ``pallas`` takes no extras."""
    if layout not in RAY_ROW_LAYOUTS:
        raise ValueError(f"unknown ray-row layout {layout!r}; choose from "
                         f"{RAY_ROW_LAYOUTS}")
    extras = 2 if active is not None else int(cap is not None)
    if layout == "pallas" and extras:
        raise ValueError("the pallas layout takes no cap or active rows")
    return 9 + extras if layout == "live" else 16


def _glue_rays(O, u, cap, active, R, dev):
    """The six (R,) f32 ray rows, cap (f32) and active (bool) or None."""
    _lanes(R, dev, *zip(("O.x", "O.y", "O.z", "u.x", "u.y", "u.z"), (*O, *u),
                        (torch.float32,) * 6),
           ("cap", cap, torch.float32), ("active", active, torch.bool))


def _plan(keys, C, shift, Rp, dev):
    """The sorted keys of a compacted cast: a contiguous (Rp,) int32 tensor
    on ``dev``, 0 <= C <= Rp and the lanes within the key's low ``shift``
    bits (Rp <= 2^shift, shift 1 to 31); returns the lane mask."""
    _lanes(Rp, dev, ("keys", keys, torch.int32))
    if not (0 <= C <= Rp and 1 <= shift <= 31 and Rp <= 1 << shift):
        raise ValueError(f"need 0 <= C <= Rp and Rp <= 2^shift with shift "
                         f"in [1, 31]; got C {C}, Rp {Rp}, shift {shift}")
    return (1 << shift) - 1


def ray_rows(O, u, cap=None, active=None, layout="pairs"):
    """Kernel rt_ray_rows: the (nrows, R) f32 ray-feature rows of
    ``ops/pallas_trace.ray_rows_plain`` (``ray_row_count`` rows)."""
    dev, R = O[0].device, O[0].shape[0]
    nrows = ray_row_count(cap, active, layout)
    _glue_rays(O, u, cap, active, R, dev)
    if nrows * R >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    _on_card(O[0])
    rows = torch.empty((nrows, R), dtype=torch.float32, device=dev)
    if R:
        ptrs = _pointers(*O, *u, cap, active, rows)
        _run("ray_rows", dev, lambda lib, st: lib.rt_ray_rows(
            ptrs, R, nrows, int(layout == "pallas"), st))
    return rows


def compact_bits(keys, C, shift, O, u, nc, subg, members, cap=None,
                 active=None):
    """Kernel rt_compact_bits: (rows (nrows, C) f32, active (C,) bool or
    None, bits (W, C/subg) int32) of ``ops/pairs_trace.compact_bits_plain``
    in one launch: the live rows of the C source lanes ``keys[:C] &
    (2^shift - 1)`` of the sorted keys (Rp,) int32 of Rp rays, their
    shadow mask, and ``pair_bits`` of those rays (O, u, cap and active at
    their lanes) over members = (member boxes (nm, >= 6) f32, member_tile
    (nm,) int32), W = ceil(nc / 32)."""
    dev, Rp = O[0].device, O[0].shape[0]
    nrows = ray_row_count(cap, active, "live")
    _glue_rays(O, u, cap, active, Rp, dev)
    mask = _plan(keys, C, shift, Rp, dev)
    boxes, member_tile = _members(members)
    if subg <= 0 or C % subg or nc < 1:
        raise ValueError(f"subgroup {subg} does not divide the {C} rays, or "
                         f"nc {nc} < 1")
    W, S = -(-nc // 32), C // subg
    if max(W * S, nrows * C) >= 2**31:
        raise ValueError("kernel indices are 32-bit: cast too large")
    _on_card(keys, boxes, member_tile)
    rows = torch.empty((nrows, C), dtype=torch.float32, device=dev)
    act = None if active is None else torch.empty(C, dtype=torch.bool,
                                                   device=dev)
    bits = torch.empty((W, S), dtype=torch.int32, device=dev)
    if C:
        ptrs = _pointers(*O, *u, cap, active, keys, boxes, member_tile, rows,
                         act, bits)
        _run("compact_bits", dev, lambda lib, st: lib.rt_compact_bits(
            ptrs, C, mask, nrows, boxes.shape[1], boxes.shape[0], subg, nc,
            st))
    return rows, act, bits


def _bits32(d, dtype) -> int:
    """The 32 bits of ``d`` as a (1,) tensor of ``dtype`` holds it."""
    return int(torch.tensor([d], dtype=dtype).view(torch.int32)) & 0xFFFFFFFF


def scatter(keys, C, shift, outs, defaults):
    """Kernel rt_scatter: the (Rp,) outputs of
    ``ops/pairs_trace.scatter_plain``: each of the (C,) f32 or int32
    ``outs`` at the source lanes of the sorted keys (Rp,) int32, its
    default on every other lane; one to SCATTER_OUTPUTS outputs."""
    dev, Rp = keys.device, keys.shape[0] if keys.dim() == 1 else -1
    n = len(outs)
    if not 1 <= n <= SCATTER_OUTPUTS or len(defaults) != n:
        raise ValueError(f"need 1 to {SCATTER_OUTPUTS} outputs and a default "
                         f"each, got {n} and {len(defaults)}")
    mask = _plan(keys, C, shift, Rp, dev)
    for k, o in enumerate(outs):
        if o.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"outs[{k}]: need float32 or int32, got "
                             f"{o.dtype}")
        _lanes(C, dev, (f"outs[{k}]", o, o.dtype))
    _on_card(keys)
    res = [torch.empty(Rp, dtype=o.dtype, device=dev) for o in outs]
    if Rp:
        ptrs = _pointers(keys, *outs, *res)
        dflt = (ctypes.c_uint32 * n)(*(_bits32(d, o.dtype)
                                       for d, o in zip(defaults, outs)))
        _run("scatter", dev, lambda lib, st: lib.rt_scatter(
            ptrs, dflt, n, C, Rp, mask, st))
    return res


def composite(steps):
    """Kernel rt_composite: the (3, R) f32 backward composite of
    ``integrator/wavefront.composite_plain`` over the depth steps
    [(is_diff (R,) bool, direct (3, R) f32, albedo (3, R) f32), ...], at
    least one; COMPOSITE_DEPTHS depths a launch, the deepest first."""
    D = len(steps)
    if D < 1:
        raise ValueError("the composite needs at least one depth step")
    dev = steps[0][0].device
    R = steps[0][0].shape[0] if steps[0][0].dim() == 1 else -1
    for d, (is_diff, direct, alb) in enumerate(steps):
        _lanes(R, dev, (f"is_diff[{d}]", is_diff, torch.bool))
        _rows3(f"direct[{d}]", direct, R, dev)
        _rows3(f"alb[{d}]", alb, R, dev)
    if 3 * R >= 2**31:
        raise ValueError("kernel indices are 32-bit: trace too large")
    _on_card(steps[0][0])
    ans = torch.empty((3, R), dtype=torch.float32, device=dev)
    if R:
        for hi in range(D, 0, -COMPOSITE_DEPTHS):
            part = steps[max(hi - COMPOSITE_DEPTHS, 0):hi]
            ptrs = _pointers(*(s[0] for s in part), *(s[1] for s in part),
                             *(s[2] for s in part), ans)
            _run("composite", dev, lambda lib, st: lib.rt_composite(
                ptrs, len(part), int(hi < D), R, st))
    return ans
