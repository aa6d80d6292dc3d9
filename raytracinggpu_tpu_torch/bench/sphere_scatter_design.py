"""rt_sphere_hit and rt_scatter of several trees on the same calls, on the
card.

    python -m raytracinggpu_tpu_torch.bench.sphere_scatter_design [DIR ...]

Builds the ``wavefront.cu`` and ``glue.cu`` of each ``csrc/`` directory
given (this package's when none is; another tree's from ``git archive``,
unpacked under the ignored ``.chip_tree/``, say) with the flags of
``ops/_kernels.py``, one nvcc process a source, all started together
(``bench/pairs_design.build_libraries``); each source must export
``rt_sphere_hit`` and ``rt_scatter`` with the C interface of
``ops/_kernels.load``.  Beside them, a copy of this tree's ``glue.cu``
under ``_build/`` with ``SCATTER_VARIANT`` added: ``rt_scatter_k``, the
scatter at several positions a thread (each warp on runs of 32
consecutive positions, the outputs unrolled) with the grid sized to the
positions or to the SMs, timed at each of ``SCATTER_VARIANTS``.  The
package's library carries none of it.

Keeps the calls of the headline frame (``array_bvh`` 512x512 spp 32 depth
5, pairs, the ladder on): rt_sphere_hit's depth-1 closest and shadow calls
(``bench/depth_step.capture``) and rt_scatter's first trace's depth-1
closest (5 outputs) and shadow (1 output) calls (``bench/cast_glue.
capture``).  On each, and on ``bench/depth_step.sphere_edge_calls`` and
the scatters of ``bench/cast_glue.adversarial_calls``, every library's
kernel at each variant must equal the plain version bit for bit (NaNs as
one value).  Then each is timed with CUDA events, replayed from a CUDA
graph (back to back) and with the L2 emptied before each call
(``bench/_timing.timed``), the variants in turns (in order, then
reversed), beside the bound of ``depth_step.call_bound`` or
``cast_glue.call_bound``.

The scatter's decomposition, on the closest call, each tree: an empty
launch (one position), C = 0 with one output and with five (the keys and
the default stores, coalesced but for the cast's lanes), the call's C
with one output and with five, C = Rp with five (every store where the
key order puts it), and C = 0 with five over keys that are the lanes in
order (every store coalesced, no lane skipped), each beside its bytes at
the memory rate.

Last, the SASS of each library's sphere kernels (``cuobjdump -sass``):
each innermost loop that holds a MUFU (the loop a sphere: one root a lane
and sphere), its instructions by class over its MUFU count, and the time
each class's pipe needs for the headline's closest call (524,288 lanes, 6
spheres) at the per-SM rates of the CUDA programming guide for compute
capability 9.0 (PIPE_RATES) and the card's largest SM clock; every
instruction also takes an issue slot, four warps' a clock on an SM.
Every line carries the card's name and power limit.  Needs a CUDA device,
nvcc and cuobjdump.

    ... sphere_scatter_design --ablate

times instead this tree's rt_sphere_hit beside copies of its
``wavefront.cu`` with one part of the sphere loop taken out (ABLATIONS:
the Veltkamp splits, the root, the exact path's code, the whole loop), on
the same calls, in turns: what each part costs.  The copies are not the
plain version's function and are not held against it.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

import torch

from raytracinggpu_tpu_torch.ops import _kernels

GRAPH_ITERS, COLD_ITERS = 50, 30
# (positions a thread, the grid sized to the SMs) of rt_scatter_k
SCATTER_VARIANTS = ((1, 0), (2, 0), (4, 0), (1, 1), (4, 1), (8, 1))
# rt_scatter_k: (the text of csrc/glue.cu it goes before, its code); the
# kernel and its launch in glue.cu's unnamed namespace, the entry point
# after glue.cu's extern "C" block
SCATTER_VARIANT = (
    ("}  // namespace\n", r"""
template <int kOut, int kPer>
__global__ void __launch_bounds__(kThreads) scatter_k_kernel(ScatterArgs a) {
  const int t = threadIdx.x & 31;
  const long long span = 32LL * kPer;  // positions a warp takes at a time
  const long long warps = static_cast<long long>(gridDim.x) * (kThreads / 32);
  for (long long w = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       w * span < a.Rp; w += warps) {
    int lane[kPer];
    uint32_t v[kPer][kOut];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const long long i = w * span + 32 * j + t;
      lane[j] = i < a.Rp ? (__ldg(a.keys + i) & a.mask) : a.Rp;
      const bool cast = i < a.C;
#pragma unroll
      for (int k = 0; k < kOut; ++k)
        v[j][k] = cast ? __ldg(a.in[k] + i) : a.dflt[k];
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (lane[j] >= a.Rp) continue;
#pragma unroll
      for (int k = 0; k < kOut; ++k) a.out[k][lane[j]] = v[j][k];
    }
  }
}

template <int kPer>
int launch_scatter_k(const ScatterArgs& a, bool sm_grid, cudaStream_t st) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return static_cast<int>(cudaGetLastError());
  const long long chunks = (a.Rp + 32LL * kPer - 1) / (32LL * kPer);
  const long long need = (chunks + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = 8LL * sms;  // 8 blocks of 256 an SM: its most
  const int blocks = static_cast<int>(sm_grid && need > cap ? cap : need);
  switch (a.n_out) {
    case 1: scatter_k_kernel<1, kPer><<<blocks, kThreads, 0, st>>>(a); break;
    case 2: scatter_k_kernel<2, kPer><<<blocks, kThreads, 0, st>>>(a); break;
    case 3: scatter_k_kernel<3, kPer><<<blocks, kThreads, 0, st>>>(a); break;
    case 4: scatter_k_kernel<4, kPer><<<blocks, kThreads, 0, st>>>(a); break;
    default: scatter_k_kernel<5, kPer><<<blocks, kThreads, 0, st>>>(a);
  }
  return finish();
}

"""),
    (None, r"""
// rt_scatter's arguments, then per: positions a thread, 1, 2, 4 or 8;
// sm_grid: the grid sized to the SMs
extern "C" int rt_scatter_k(void* const* p, const uint32_t* dflt, int n_out,
                            int C, int Rp, int mask, int per, int sm_grid,
                            void* stream) {
  if (n_out < 1 || n_out > kMaxOut) return cudaErrorInvalidValue;
  ScatterArgs a{};
  int k = 0;
  take(a.keys, p, k);
  for (int j = 0; j < n_out; ++j) take(a.in[j], p, k);
  for (int j = 0; j < n_out; ++j) take(a.out[j], p, k);
  for (int j = 0; j < n_out; ++j) a.dflt[j] = dflt[j];
  a.n_out = n_out;
  a.C = C;
  a.Rp = Rp;
  a.mask = mask;
  auto st = static_cast<cudaStream_t>(stream);
  switch (per) {
    case 1: return launch_scatter_k<1>(a, sm_grid, st);
    case 2: return launch_scatter_k<2>(a, sm_grid, st);
    case 4: return launch_scatter_k<4>(a, sm_grid, st);
    case 8: return launch_scatter_k<8>(a, sm_grid, st);
    default: return cudaErrorInvalidValue;
  }
}
"""))
VARIANTS = "rt_scatter_k"  # the label of the library built with them
# SASS opcode classes and their rate, results a clock on an SM (the CUDA
# C++ programming guide's throughput table, compute capability 9.0);
# "issue": every instruction, four warp schedulers
PIPE_RATES = {"F2F (f32<->f64)": 16, "f64 DADD/DMUL/DFMA/DSETP": 64,
              "MUFU": 16, "f32 FADD/FMUL/FFMA": 128,
              "integer, logic, compare, select": 64, "issue": 128}
_CLASS = (("F2F (f32<->f64)", r"F2F$"),
          ("f64 DADD/DMUL/DFMA/DSETP", r"D(ADD|MUL|FMA|SETP|MNMX)$"),
          ("MUFU", r"MUFU$"),
          ("f32 FADD/FMUL/FFMA", r"F(ADD|MUL|FMA)$"),
          ("integer, logic, compare, select",
           r"(IADD3|IMAD|LOP3|SHF|LEA|ISETP|IMNMX|VIADDMNMX|VIADD|SEL|PRMT|"
           r"IABS|FSETP|FMNMX|FSEL|FCHK|PLOP3|P2R|R2P|I2F|F2I|FRND|POPC|"
           r"FLO|BMSK|SGXT)$"))


# rt_sphere_hit with one part of its loop taken out: (the text of
# csrc/wavefront.cu, what replaces it); time only, the results differ
ABLATIONS = {
    "no Veltkamp split (round24(x) = x)": (
        "  const double c = x * kSplit;\n  return c - (c - x);",
        "  return x;"),
    "no root (sq = the clamped delta)": (
        "      const float root = sqrtf(c0 > 0.0f ? c0 : 1.0f);\n"
        "      const float sq = c0 > 0.0f ? root : c0;",
        "      const float sq = c0;"),
    "no exact path (its code left out)": (
        "  if (!(table_ok && fast && tiny >= kTinyKey))\n"
        "    exact_nearest(a, O, u, best, arg);", ""),
    "no sphere loop (loads, stores, the normal)": (
        "    for (int s = 0; s < n; ++s) {\n      const double4 q = tab[s];",
        "    for (int s = 0; s < 0; ++s) {\n      const double4 q = tab[s];"),
}


def label(csrc) -> str:
    return ("this tree" if os.path.samefile(csrc, _kernels.CSRC)
            else csrc)


def _bind(path):
    """The library at ``path`` with the argtypes of those of its entry
    points this bench calls."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"rt_sphere_hit": [p, i, i, i, p],
            "rt_scatter": [p, p, i, i, i, i, p],
            "rt_scatter_k": [p, p, i, i, i, i, i, i, p]}
    for name, args in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
    return lib


def _ptrs(*xs):
    return (ctypes.c_void_p * len(xs))(
        *(None if x is None else x.data_ptr() for x in xs))


def _raise(err, name):
    if err:  # the error's name from the package's library
        _kernels._raise_on(_kernels.load(), err, name)


def sphere_outputs(kind, args):
    """Fresh outputs of a sphere_hit call: t, then obj and N (closest) or
    the active lanes (shadow with active)."""
    O = args[0]
    R, dev = O.x.shape[0], O.x.device
    new = lambda dt=torch.float32: torch.empty(R, dtype=dt, device=dev)
    if kind == "closest":
        return [new(), new(torch.int32), new(), new(), new()]
    return [new()] + ([new(torch.bool)] if args[3] is not None else [])


def sphere_launch(lib, kind, args, outs):
    """One rt_sphere_hit call from ``lib`` on a kept call's args into
    ``outs`` (``sphere_outputs``; not counted in LAUNCHES)."""
    O, u, tab = args[:3]
    active, lv2 = (args[3], args[4]) if kind == "shadow" else (None, None)
    full = kind == "closest"
    t = outs[0]
    obj, N = (outs[1], outs[2:5]) if full else (None, (None,) * 3)
    act = outs[1] if not full and active is not None else None
    p = _ptrs(*O, *u, *tab, active, lv2, t, obj, *N, act)
    st = torch.cuda.current_stream().cuda_stream
    R, S = O.x.shape[0], tab.radius.shape[0]
    _raise(lib.rt_sphere_hit(p, R, S, int(full), st), "sphere_hit")
    return outs


def scatter_outputs(args, n=None, Rp=None):
    keys, _, _, ins, _ = args
    Rp = keys.shape[0] if Rp is None else Rp
    return [torch.empty(Rp, dtype=x.dtype, device=keys.device)
            for x in ins[:n]]


def scatter_launch(lib, args, outs, per=None, C=None, Rp=None):
    """One rt_scatter call from ``lib`` on a kept call's args (keys, C,
    shift, ins, defaults) into ``outs`` (as many outputs as ``outs``
    holds), with C and Rp overridden when given, at ``per`` = (positions
    a thread, the grid sized to the SMs) when given (not counted in
    LAUNCHES)."""
    keys, C0, shift, ins, dflt = args
    n = len(outs)
    C = C0 if C is None else C
    Rp = keys.shape[0] if Rp is None else Rp
    p = _ptrs(keys, *ins[:n], *outs)
    d = (ctypes.c_uint32 * n)(*(_kernels._bits32(v, x.dtype)
                                for v, x in zip(dflt[:n], ins[:n])))
    st = torch.cuda.current_stream().cuda_stream
    mask = (1 << shift) - 1
    err = (lib.rt_scatter(p, d, n, C, Rp, mask, st) if per is None
           else lib.rt_scatter_k(p, d, n, C, Rp, mask, *per, st))
    _raise(err, "scatter")
    return outs


def headline_calls(device):
    """({"closest": args, "shadow": args} of rt_sphere_hit's depth-1 calls,
    the same of rt_scatter's first trace's depth-1 casts, the headline's
    sphere table) of the headline frame."""
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.bench import depth_step as ds
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5)
    frame = lambda: render_frame(tables, cfg, Camera.default(cfg, device),
                                 PRNGKey(0, device))
    kept, _ = ds.capture(frame)
    sph = {kind: next(a for lab, kd, a in kept["sphere_hit"]
                      if lab == "depth 1" and kd == kind)
           for kind in ("closest", "shadow")}
    kept, _ = cg.capture(frame, depths=2)
    sca = {kind: next(a for lab, kd, a in kept["scatter"]
                      if lab.startswith(f"trace 0 depth 1 {kind}"))
           for kind in ("closest", "shadow")}
    torch.cuda.synchronize()
    return sph, sca, tables.spheres


def write_variants() -> str:
    """This tree's glue.cu with SCATTER_VARIANT added, written under
    _build/; returns its directory."""
    with open(os.path.join(_kernels.CSRC, "glue.cu")) as f:
        text = f.read()
    for before, code in SCATTER_VARIANT:
        if before is None:
            text += code
        elif before in text:
            text = text.replace(before, code + before, 1)
        else:
            raise SystemExit(f"design: csrc/glue.cu no longer holds "
                             f"{before!r}")
    d = os.path.join(_kernels.BUILD_DIR, "scatter_variants")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "glue.cu"), "w") as f:
        f.write(text)
    return d


def hold(libs, sph, sca, spheres, device, card) -> None:
    """Every library at each variant bitwise its plain version on the kept
    calls, the edge lanes and the hard scatters (the sphere calls where it
    has rt_sphere_hit); raises SystemExit on a difference."""
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.bench import depth_step as ds

    sphere_calls = [(k, a) for k, a in sph.items()] + [
        (kind, a) for seed in (0, 1)
        for _, _, kind, a in ds.sphere_edge_calls(spheres, seed=seed)]
    scatter_calls = list(sca.values()) + [
        a for seed in (0, 1) for k, _, _, a in cg.adversarial_calls(
            device, seed=seed) if k == "scatter"]
    for v, (lib, pers) in libs.items():
        n = 0
        for kind, a in (sphere_calls if hasattr(lib, "rt_sphere_hit")
                        else ()):
            want = ds.call("sphere_hit", kind, a, True)
            got = sphere_launch(lib, kind, a, sphere_outputs(kind, a))
            torch.cuda.synchronize()
            if not ds.same_bits(got, want):
                raise SystemExit(f"design: {v}'s sphere_hit differs "
                                 f"from the plain version on a {kind} call")
            n += 1
        for a in scatter_calls:
            want = cg.call("scatter", a, True)
            for per in pers:
                got = scatter_launch(lib, a, scatter_outputs(a), per)
                torch.cuda.synchronize()
                if not ds.same_bits(got, want):
                    raise SystemExit(f"design: {v}'s scatter (per "
                                     f"{per}) differs from the plain version "
                                     f"(C {a[1]} of {a[0].shape[0]})")
                n += 1
        print(f"{v}: {n} calls bitwise the plain versions (scatter at "
              f"{pers}; the headline's depth-1 calls, the edge lanes, the "
              f"hard scatters) on {card}", flush=True)


def _times(fn):
    from raytracinggpu_tpu_torch.bench._timing import timed

    return (timed(fn, GRAPH_ITERS, graph=True) * 1e3,
            timed(fn, COLD_ITERS, graph=True, flush_l2=True) * 1e3)


def time_rows(libs, sph, sca, card) -> dict:
    """Each kernel at each library and variant on the kept calls, in
    turns; returns {(kernel, kind): {(tree, variant): [(graph ms, cold
    ms), ...]}}."""
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.bench import depth_step as ds

    results = {}
    rows = [("sphere_hit", kind, a) for kind, a in sph.items()] + \
        [("scatter", kind, a) for kind, a in sca.items()]
    for kernel, kind, a in rows:
        variants = []
        for v, (lib, pers) in libs.items():
            if kernel == "sphere_hit" and not hasattr(lib, "rt_sphere_hit"):
                continue
            for x in ((None,) if kernel == "sphere_hit" else pers):
                if kernel == "sphere_hit":
                    outs = sphere_outputs(kind, a)
                    fn = (lambda lib=lib, outs=outs:
                          sphere_launch(lib, kind, a, outs))
                else:
                    outs = scatter_outputs(a)
                    fn = (lambda lib=lib, x=x, outs=outs:
                          scatter_launch(lib, a, outs, x))
                variants.append((v, x, fn))
        if kernel == "sphere_hit":
            outs = ds.call(kernel, kind, a, True)
            bound, by = ds.call_bound(kernel, kind, a, outs)
            size = f"{a[0].x.shape[0]} lanes x {a[2].radius.shape[0]} spheres"
        else:
            outs = cg.call(kernel, a, True)
            bound, by = cg.call_bound(kernel, a, outs)
            size = (f"C {a[1]} of {a[0].shape[0]}, {len(a[3])} output"
                    f"{'s' if len(a[3]) > 1 else ''}")
        res = results[kernel, kind] = {}
        for order in (variants, variants[::-1]):
            for v, x, fn in order:
                res.setdefault((v, x), []).append(_times(fn))
        for (v, x), ms in res.items():
            g = [a for a, _ in ms]
            c = [b for _, b in ms]
            what = ("" if x is None else
                    f", (positions a thread, SM-sized grid) {x}")
            print(f"{kernel} {kind} ({size}), {v}{what}: graph {', '.join(f'{t:.4f}' for t in g)}"
                  f" ms, L2 emptied {', '.join(f'{t:.4f}' for t in c)} ms; "
                  f"bound {bound:.4f} ms ({by}; {bound / min(g):.1%}, L2 "
                  f"emptied {bound / min(c):.1%}; 1.5x the bound "
                  f"{'met' if min(g) <= 1.5 * bound else 'missed'}) on "
                  f"{card}", flush=True)
    return results


def scatter_parts(libs, sca, card, device) -> None:
    """The scatter's decomposition on the closest call (module
    docstring), each library at its default."""
    from raytracinggpu_tpu_torch.bench.depth_step import PEAK_BYTES_S

    keys, C, shift, ins, dflt = a = sca["closest"]
    Rp = keys.shape[0]
    gen = torch.Generator(device=device).manual_seed(0)
    full = tuple(torch.randint(-2**31, 2**31 - 1, (Rp,), generator=gen,
                               device=device, dtype=torch.int32).view(x.dtype)
                 for x in ins)
    wide = (keys, Rp, shift, full, dflt)
    lanes = torch.arange(Rp, dtype=torch.int32, device=device)
    in_order = (lanes, C, shift, ins, dflt)
    parts = (("an empty launch (one position)", a, 1, 0, 1),
             ("C 0, 1 output", a, 1, 0, None),
             ("C 0, 5 outputs", a, 5, 0, None),
             (f"C {C}, 1 output", a, 1, None, None),
             (f"C {C}, 5 outputs (the call)", a, 5, None, None),
             (f"C {Rp} (every position cast), 5 outputs", wide, 5, None,
              None),
             ("C 0, 5 outputs, the keys the lanes in order (coalesced)",
              in_order, 5, 0, None))
    for v, (lib, _) in libs.items():
        for name, args, n, c, rp in parts:
            outs = scatter_outputs(args, n, rp)
            fn = lambda: scatter_launch(lib, args, outs, None, c, rp)
            g, cold = _times(fn)
            Rn = Rp if rp is None else rp
            Cn = args[1] if c is None else c
            nbytes = 4 * Rn + 4 * n * (Cn + Rn)
            print(f"scatter parts, {v}: {name}: graph {g:.4f} ms, L2 "
                  f"emptied {cold:.4f} ms; bytes {nbytes} at the memory rate "
                  f"{nbytes / PEAK_BYTES_S * 1e3:.4f} ms on {card}",
                  flush=True)


def _opcode(text: str) -> str:
    m = re.match(r"(?:@!?U?P[T0-9]+\s+)?([A-Z0-9_]+)", text)
    return m.group(1) if m else ""


def loop_counts(instrs) -> list:
    """[(address range, {class: count}, MUFU count, instructions)] of each
    innermost loop (a backward branch with no other loop inside) that
    holds a MUFU."""
    addr = [a for a, _ in instrs]
    loops = []
    for i, (a, t) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a and int(m.group(1), 16) in addr:
            loops.append((addr.index(int(m.group(1), 16)), i))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                        for l2, h2 in loops)]
    out = []
    for lo, hi in sorted(set(inner)):
        ops = [_opcode(t) for _, t in instrs[lo:hi + 1]]
        mufu = sum(o == "MUFU" for o in ops)
        if not mufu:
            continue
        counts = {name: sum(bool(re.match(pat, o)) for o in ops)
                  for name, pat in _CLASS}
        out.append(((instrs[lo][0], instrs[hi][0]), counts, mufu, len(ops)))
    return out


def disasm(path):
    """{kernel: [(address, text)]} of the SASS of the library at ``path``,
    sphere_kernel named with its template argument (sphere_kernel<1>: the
    closest mode)."""
    tool = os.path.join(os.path.dirname(_kernels.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            k = re.search(r"(\d+)(sphere_kernel)I(.*?)EE", name)
            if k:
                args = re.findall(r"L[bi](\d+)E", k.group(3) + "E")
                name = f"{k.group(2)}<{','.join(args)}>"
            cur = funcs.setdefault(name, [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def sm_clock_hz() -> tuple[float, str]:
    """The card's largest SM clock (nvidia-smi clocks.max.sm), or the
    H100 SXM's 1,980 MHz boost where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=60)
        return float(out.stdout.split()[0]) * 1e6, "clocks.max.sm"
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return 1.98e9, "the H100 SXM's boost clock"


def sass_report(paths, card, lanes: int = 524288, spheres: int = 6,
                funcs=None) -> dict:
    """The sphere kernels' loop counts a lane and sphere of each library
    (``loop_counts`` over MUFU), printed with each pipe's time for
    ``lanes`` x ``spheres``; ``funcs``: {key of ``paths``: ``disasm`` of
    its library} already read, where given; returns {(tree, kernel):
    [per-sphere counts of each loop]}."""
    hz, src = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for v, path in paths.items():
        try:
            fs = (funcs or {}).get(v) or disasm(path)
        except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
            print(f"sass {label(v)}: not read ({e})")
            continue
        for name in sorted(f for f in fs if f.startswith("sphere_kernel")):
            f2f_all = sum(_opcode(t) == "F2F" for _, t in fs[name])
            for rng, counts, mufu, n in loop_counts(fs[name]):
                per = {k: c / mufu for k, c in counts.items()}
                per["issue"] = n / mufu
                out.setdefault((label(v), name), []).append(per)
                us = {k: per[k] * lanes * spheres / (sms * PIPE_RATES[k] * hz)
                      * 1e6 for k in PIPE_RATES}
                busiest = max(us, key=us.get)
                print(f"sass {label(v)} {name}: loop {rng[0]:#x}-{rng[1]:#x}, "
                      f"{mufu} MUFU an iteration; a lane and sphere: "
                      + ", ".join(f"{k} {per[k]:.2f}" for k in PIPE_RATES)
                      + f"; pipe us for {lanes} lanes x {spheres} spheres at "
                      f"{hz / 1e6:.0f} MHz ({src}), {sms} SMs: "
                      + ", ".join(f"{k} {t:.2f}" for k, t in us.items())
                      + f" (busiest: {busiest}); F2F in the whole kernel "
                      f"{f2f_all}; on {card}", flush=True)
    return out


def run(sources, card: str, device="cuda") -> dict:
    from raytracinggpu_tpu_torch.bench.pairs_design import (
        build_libraries, kernel_resources)

    dev = torch.device(device)
    vdir = write_variants()
    built = build_libraries([(v, f) for v in sources
                             for f in ("wavefront.cu", "glue.cu")]
                            + [(vdir, "glue.cu")])
    libs = {}
    for v in sources:
        wf, glue = (_bind(built[v, f][0]) for f in ("wavefront.cu",
                                                    "glue.cu"))
        libs[label(v)] = (_Both(wf, glue), (None,))
        for f in ("wavefront.cu", "glue.cu"):
            res = kernel_resources(built[v, f][1])
            print(f"{label(v)} {f}: " + ", ".join(
                f"{k}: {r} registers, {s} B smem"
                for k, (r, s) in sorted(res.items())
                if "sphere" in k or "scatter" in k) + f"; built for {card}")
    libs[VARIANTS] = (_bind(built[vdir, "glue.cu"][0]), SCATTER_VARIANTS)
    sph, sca, spheres = headline_calls(dev)
    hold(libs, sph, sca, spheres, dev, card)
    results = time_rows(libs, sph, sca, card)
    scatter_parts({v: x for v, x in libs.items() if v != VARIANTS}, sca,
                  card, dev)
    sass_report({v: built[v, "wavefront.cu"][0] for v in sources}, card,
                lanes=sph["closest"][0].x.shape[0],
                spheres=spheres.radius.shape[0])
    return results


def ablate(card, device="cuda") -> None:
    """This tree's rt_sphere_hit beside each of ABLATIONS (built from
    edited copies of its wavefront.cu under _build/), on the headline's
    depth-1 calls, graph-replayed and with the L2 emptied, in turns."""
    from raytracinggpu_tpu_torch.bench.pairs_design import build_libraries

    with open(os.path.join(_kernels.CSRC, "wavefront.cu")) as f:
        text = f.read()
    dirs = {"this tree": _kernels.CSRC}
    for k, (name, (old, new)) in enumerate(ABLATIONS.items()):
        if old not in text:
            raise SystemExit(f"ablate: csrc/wavefront.cu no longer holds the "
                             f"text of {name!r}")
        d = os.path.join(_kernels.BUILD_DIR, f"ablate_{k}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "wavefront.cu"), "w") as f:
            f.write(text.replace(old, new))
        dirs[name] = d
    built = build_libraries([(d, "wavefront.cu") for d in dirs.values()])
    libs = {n: _bind(built[d, "wavefront.cu"][0]) for n, d in dirs.items()}
    sph, _, _ = headline_calls(torch.device(device))
    for kind, a in sph.items():
        res = {}
        for order in (list(libs), list(libs)[::-1]):
            for n in order:
                outs = sphere_outputs(kind, a)
                res.setdefault(n, []).append(_times(
                    lambda: sphere_launch(libs[n], kind, a, outs)))
        for n, ms in res.items():
            print(f"ablate sphere_hit {kind} ({a[0].x.shape[0]} lanes x "
                  f"{a[2].radius.shape[0]} spheres), {n}: graph "
                  + ", ".join(f"{g:.4f}" for g, _ in ms) + " ms, L2 emptied "
                  + ", ".join(f"{c:.4f}" for _, c in ms) + " ms (time only"
                  + ("" if n == "this tree" else ", not the plain version's "
                     "function") + f") on {card}", flush=True)


class _Both:
    """One tree's two libraries as one: its sphere entry points from
    wavefront.cu's, its scatter ones from glue.cu's."""

    def __init__(self, wf, glue):
        self._wf, self._glue = wf, glue

    def __getattr__(self, name):
        return getattr(self._glue if "scatter" in name else self._wf, name)


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", default=[_kernels.CSRC],
                    help="csrc/ directories whose wavefront.cu and glue.cu "
                         "to time")
    ap.add_argument("--ablate", action="store_true",
                    help="time this tree's rt_sphere_hit beside ABLATIONS "
                         "instead")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sphere_scatter_design: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    if a.ablate:
        ablate(card)
    else:
        run(a.csrc, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
