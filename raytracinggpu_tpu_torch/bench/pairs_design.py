"""The pairs kernels of several trees on the same casts, on the card.

    python -m raytracinggpu_tpu_torch.bench.pairs_design [DIR ...]

Builds the ``pairs_trace.cu`` of each ``csrc/`` directory given (this
package's when none is; another tree's from ``git archive``, say), with
the flags of ``ops/_kernels.py``, one nvcc process per source, all started
together, into ``_build/``; each source must keep the C interface of
``ops/_kernels._SPECS``.  Then captures the depth-1 casts of B1 and B2
that the main-path frame (``array_bvh``, 512x512, spp 32, depth 5, pairs)
launches first, at the preset's subgroup and at subgroup 16 (the same
frame), and times each source's kernels on them with CUDA events: ms, ps
a Moller-Trumbore test and the share of the no-FMA floor, beside the
registers ptxas reports.  Each must equal the plain version bit for bit
on every cast.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import subprocess

import torch

from raytracinggpu_tpu_torch.ops import _kernels

# H100 SXM (NVIDIA's data sheet): f32 outside the tensor cores, counting an
# FMA as two operations; without FMA a lane retires one operation a cycle
PEAK_F32_FLOPS = 67e12
NO_FMA_OPS_S = PEAK_F32_FLOPS / 2
PEAK_BYTES_S = 3.35e12  # HBM3
FLOP_PER_TEST = 39
KERNELS = ("pairs_closest", "pairs_shadow")


def label(csrc) -> str:
    return ("this tree" if os.path.samefile(csrc, _kernels.CSRC)
            else csrc)


def build_libraries(jobs):
    """{(csrc, file): (library path, ptxas report)}: the source ``file`` of
    each ``csrc`` directory in ``jobs`` built into a shared library of its
    own, one nvcc process a distinct source, all started together; a
    library already built from the same source, headers and flags is kept
    (its report is then empty)."""
    nvcc = _kernels.find_nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for csrc, file in jobs:
        text = b""
        for name in [file] + sorted(n for n in os.listdir(csrc)
                                    if n.endswith(".cuh")):
            with open(os.path.join(csrc, name), "rb") as f:
                text += name.encode() + b"\0" + f.read()
        key = hashlib.sha256(text + " ".join(_kernels.NVCC_FLAGS).encode()
                             ).hexdigest()[:12]
        stem = os.path.splitext(file)[0]
        path = out[csrc, file] = os.path.join(_kernels.BUILD_DIR,
                                              f"design_{stem}_{key}.so")
        if not os.path.isfile(path) and path not in (
                out[j] for j in procs):  # one build a source
            procs[csrc, file] = subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, "-shared", "-o",
                 f"{path}.{os.getpid()}.tmp", os.path.join(csrc, file)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    reports = {}
    for job, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {job[1]} of {job[0]}:\n{err}")
        os.replace(f"{out[job]}.{os.getpid()}.tmp", out[job])
        reports[out[job]] = err
    return {job: (path, reports.get(path, "")) for job, path in out.items()}


def build(sources):
    """{csrc: (library path, ptxas report)}: each csrc's pairs_trace.cu
    (see build_libraries)."""
    built = build_libraries([(v, "pairs_trace.cu") for v in sources])
    return {v: built[v, "pairs_trace.cu"] for v in sources}


def _kernel_name(mangled: str) -> str | None:
    """A kernel's identifier and mangled template arguments from its
    mangled name, whatever namespace nvcc gave it: the last name of
    ``_ZN<len><name>...`` (or the name of ``_Z<len><name>``) followed by
    its ``I...E`` arguments (pairs_kernelILi2E is pairs_kernel<2>)."""
    s = mangled[3:] if mangled.startswith("_ZN") else mangled[2:]
    name = None
    while s[:1].isdigit():
        d = re.match(r"\d+", s).group()
        name, s = s[len(d):len(d) + int(d)], s[len(d) + int(d):]
        if not mangled.startswith("_ZN"):
            break
    if name and s.startswith("I"):
        name += s[:s.index("E") + 1]
    return name


def kernel_resources(report: str) -> dict:
    """{kernel: (registers, shared-memory bytes)} from a ptxas -v report,
    each kernel named by ``_kernel_name``."""
    res, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"function '(_Z\w+)'", line)
            entry = _kernel_name(m.group(1)) if m else None
        elif entry and "registers" in line:
            smem = re.search(r"(\d+) bytes smem", line)
            res[entry] = (int(re.search(r"Used (\d+) registers", line)
                              .group(1)), int(smem.group(1)) if smem else 0)
    return res


def registers(report: str) -> dict:
    """{mangled template arguments: registers} of the pairs kernels in a
    ptxas -v report (mode first: ILi2E... is B1)."""
    return {k[len("pairs_kernel"):]: regs
            for k, (regs, _) in kernel_resources(report).items()
            if k.startswith("pairs_kernelI")}


def _lib(path):
    lib = ctypes.CDLL(path)
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in KERNELS:
        cfun, _, dts, _ = _kernels._SPECS[name]
        fn = getattr(lib, cfun)
        fn.argtypes = [p, p, p, i, i, i, i, i, fl] + [p] * len(dts) + [p]
        fn.restype = i
    lib.rt_cuda_error_string.argtypes = [i]
    lib.rt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(lib, name, rfT, fields, bits, eps, subg, tile_t):
    """One launch of kernel ``name`` from one source's library (not counted
    in ``_kernels.LAUNCHES``); returns the output tuple."""
    cfun, rows, dts, kind = _kernels._SPECS[name]
    R, Tc, n = _kernels._check(rfT, fields, bits, subg, tile_t, rows, kind)
    outs = tuple(torch.empty(R, dtype=dt, device=rfT.device) for dt in dts)
    err = getattr(lib, cfun)(
        rfT.data_ptr(), fields.data_ptr(), bits.data_ptr(), R, Tc, n, subg,
        tile_t, max(float(eps), 0.0), *(o.data_ptr() for o in outs),
        torch.cuda.current_stream().cuda_stream)
    _kernels._raise_on(lib, err, name)
    return outs


def first_casts(tables, cfg, kernels, device, n=2):
    """{kernel: [(rfT, culling input), ...]}: the inputs of the first ``n``
    launches of each wrapper in ``kernels`` during one frame of ``cfg``
    (the depth-0, depth-1, ... casts of its first wavefront); the wrappers
    launch as always and are put back afterwards."""
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame

    kept = {k: [] for k in kernels}
    orig = {k: getattr(_kernels, k) for k in kernels}

    def keeping(k):
        def wrapped(rfT, fields, cull, *rest):
            if len(kept[k]) < n:
                kept[k].append((rfT.clone(), cull.clone()))
            return orig[k](rfT, fields, cull, *rest)
        return wrapped

    for k in kernels:
        setattr(_kernels, k, keeping(k))
    try:
        render_frame(tables, cfg, Camera.default(cfg, device),
                     PRNGKey(0, device))
    finally:
        for k, f in orig.items():
            setattr(_kernels, k, f)
    return kept


def depth1_casts(device, subg=None):
    """(config, table, {kernel: (rfT, bits)}): the depth-1 casts of B1 and
    B2 that the main-path frame launches first (its first wavefront's
    first cast), at the preset's subgroup or ``subg``."""
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    over = {} if subg is None else {"pairs_subgroup": subg}
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5, **over)
    kept = first_casts(tables, cfg, KERNELS, device)
    return cfg, tables.pairs_mesh, {k: v[1] for k, v in kept.items()}


def mt_tests(bits, subg: int, tile_t: int) -> int:
    """Moller-Trumbore tests of a cast: set bits x tile_t x subg."""
    w = bits.to(torch.int64) & 0xFFFFFFFF
    return int(sum(int(((w >> b) & 1).sum()) for b in range(32))) \
        * tile_t * subg


def run(sources, iters: int = 20, device="cuda", card: str = ""):
    """Times every source on the casts; returns {csrc: {(kernel, subg):
    ms}}."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    built = build(sources)
    libs = {v: _lib(path) for v, (path, _) in built.items()}
    for v, (_, report) in built.items():
        print(f"{label(v)}: registers "
              + ", ".join(f"{m}: {n}"
                          for m, n in sorted(registers(report).items())))
    cfg, tab, casts = depth1_casts(device)
    cases = [(cfg.pairs_subgroup, casts)]
    if cfg.pairs_subgroup != 16:
        cases.append((16, depth1_casts(device, 16)[2]))
    results = {v: {} for v in sources}
    for subg, kept in cases:
        for k in KERNELS:
            rfT, bits = kept[k]
            args = (rfT, tab.fields, bits, cfg.eps_leaf, subg,
                    pt.tile_width(tab))
            want = getattr(pt, f"{k}_plain")(*args)
            want = want if isinstance(want, tuple) else (want,)
            tests = mt_tests(bits, subg, pt.tile_width(tab))
            floor_ms = tests * FLOP_PER_TEST / NO_FMA_OPS_S * 1e3
            for v, lib in libs.items():
                got = launch(lib, k, *args)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"pairs_design: {label(v)}'s {k} at "
                                     f"subgroup {subg} differs from the "
                                     "plain version")
                ms = timed(lambda: launch(lib, k, *args), iters) * 1e3
                results[v][(k, subg)] = ms
                print(f"{k} depth-1 cast ({rfT.shape[1]} rays, subgroup "
                      f"{subg}, {tests} MT tests), {label(v)}: "
                      f"{ms:.4f} ms, {ms * 1e9 / tests:.3f} ps a test, "
                      f"no-FMA floor {floor_ms:.4f} ms "
                      f"({floor_ms / ms:.1%}), bitwise the plain version, "
                      f"on {card}", flush=True)
    return results


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", default=[_kernels.CSRC],
                    help="csrc/ directories whose pairs_trace.cu to time")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pairs_design: needs a CUDA device")
    run(a.csrc, a.iters, card=card_line())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
