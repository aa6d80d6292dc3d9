"""Build, load and launch the hand-written CUDA kernels.

``csrc/pairs_trace.cu`` (B0-B3), ``csrc/pallas_trace.cu`` (B5, B6) and
``csrc/micro_kernel.cu`` (the probes B7a-e), which share the
Moller-Trumbore test of ``csrc/mt.cuh`` (and B0-B3, B5, B6 and B7e the
staging of ``csrc/stage.cuh``), and ``csrc/cull.cu`` (the culling:
``pair_bits`` and ``compact_key`` of the pairs traversal, ``tile_lists``
of the tiled one), are compiled by ``nvcc`` for
``sm_90a``, one process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, into ``raytracinggpu_tpu_torch/_build/`` under a name keyed by a hash
of every file in ``csrc/`` and the flags, and loaded with ctypes.
Nothing is compiled or loaded when this module is imported.

``--fmad=false`` keeps nvcc from contracting a*b+c into an FMA, so the
kernels round every product and sum as PyTorch's eager ops do and match
the plain versions in ``ops/pairs_trace.py``, ``ops/pallas_trace.py`` and
``bench/micro_kernel.py`` bit for bit.

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
                          "micro_kernel.cu", "cull.cu"))
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

# The culling kernels of csrc/cull.cu (see pair_bits, compact_key and
# tile_lists).
CULLING = ("pair_bits", "compact_key", "tile_lists")

# Kernel launches since the last reset_launches(), by wrapper.
LAUNCHES = {name: 0 for name in (*_SPECS, *PROBES, *CULLING)}

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
                ("rt_tile_lists_k", [p] * 7 + [i, p, i, i, i, p, p, i, p])):
            fn = getattr(lib, cfun)
            fn.argtypes = args
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
    """The probe and culling kernels take tensors of one CUDA device (a
    CPU tensor's place is the plain version in bench/micro_kernel.py,
    ops/pairs_trace.py or ops/pallas_trace.py)."""
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


def pair_bits(O, u, nc, subg, members, cap=None, active=None):
    """Culling kernel (rt_pair_bits): the (W, R/subg) int32 active-tile
    bitmask of ``ops/pairs_trace.pair_bits_plain``, W = ceil(nc / 32);
    members = (member boxes (nm, 8) f32, member_tile (nm,) int32)."""
    boxes, member_tile = members
    rows, cap, active, R = _ray_rows(O, u, cap, active)
    _boxes("member boxes", boxes)
    if member_tile.dtype != torch.int32 or member_tile.shape != (
            boxes.shape[0],) or not member_tile.is_contiguous():
        raise ValueError(f"member_tile: need a contiguous ({boxes.shape[0]},)"
                         f" int32 tensor, got {member_tile.dtype} "
                         f"{tuple(member_tile.shape)}")
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
    n_tiles boxes of ``aabb`` (n, >= 6) f32; a (W, R/subg) int32 bitmask
    is its scratch, W = ceil(n_tiles / 32)."""
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
        bits = torch.empty((W, S), dtype=torch.int32, device=dev)
        _run("tile_lists", dev, lambda lib, st: lib.rt_tile_lists(
            *(x.data_ptr() for x in rows), aabb.data_ptr(), aabb.shape[1],
            _ptr(cap), R, subg, n_tiles, bits.data_ptr(), lists.data_ptr(),
            st))
    return lists
