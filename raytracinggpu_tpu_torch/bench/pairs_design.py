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
FLOP_PER_TEST = 39
KERNELS = ("pairs_closest", "pairs_shadow")


def label(csrc) -> str:
    return ("this tree" if os.path.samefile(csrc, _kernels.CSRC)
            else csrc)


def build(sources):
    """{csrc: (library path, ptxas report)}: each csrc's pairs_trace.cu,
    skipped where built."""
    nvcc = _kernels.find_nvcc()
    os.makedirs(_kernels.BUILD_DIR, exist_ok=True)
    out, procs = {}, {}
    for csrc in sources:
        src = os.path.join(csrc, "pairs_trace.cu")
        text = b""
        for name in ("pairs_trace.cu", "mt.cuh"):
            with open(os.path.join(csrc, name), "rb") as f:
                text += f.read()
        key = hashlib.sha256(text + " ".join(_kernels.NVCC_FLAGS).encode()
                             ).hexdigest()[:12]
        path = out[csrc] = os.path.join(_kernels.BUILD_DIR,
                                        f"pairs_design_{key}.so")
        if not os.path.isfile(path):
            procs[csrc] = subprocess.Popen(
                [nvcc, *_kernels.NVCC_FLAGS, "-shared", "-o",
                 f"{path}.{os.getpid()}.tmp", src], stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    reports = {}
    for v, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {v}:\n{err}")
        os.replace(f"{out[v]}.{os.getpid()}.tmp", out[v])
        reports[v] = err
    return {v: (path, reports.get(v, "")) for v, path in out.items()}


def registers(report: str) -> dict:
    """{mangled template arguments: registers} of the pairs kernels in a
    ptxas -v report (mode first: ILi2E... is B1)."""
    regs, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"pairs_kernel(I\w*?E)E", line)
        if "Compiling entry function" in line:
            entry = m.group(1) if m else None
        elif entry and "registers" in line:
            regs[entry] = int(re.search(r"Used (\d+) registers", line)
                              .group(1))
    return regs


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


def depth1_casts(device, subg=None):
    """(config, table, {kernel: (rfT, bits)}): the depth-1 casts of B1 and
    B2 that the main-path frame launches first (its first wavefront's
    first cast), at the preset's subgroup or ``subg``."""
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    over = {} if subg is None else {"pairs_subgroup": subg}
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5, **over)
    kept = {k: [] for k in KERNELS}
    orig = {k: getattr(_kernels, k) for k in KERNELS}

    def keeping(k):
        def wrapped(rfT, fields, bits, *rest):
            if len(kept[k]) < 2:
                kept[k].append((rfT.clone(), bits.clone()))
            return orig[k](rfT, fields, bits, *rest)
        return wrapped

    for k in KERNELS:
        setattr(_kernels, k, keeping(k))
    try:
        render_frame(tables, cfg, Camera.default(cfg, device),
                     PRNGKey(0, device))
    finally:
        for k, f in orig.items():
            setattr(_kernels, k, f)
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
