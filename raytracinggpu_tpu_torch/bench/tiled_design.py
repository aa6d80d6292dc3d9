"""The tiled closest-hit kernel B5 (the shadow kernel B6 beside it, the
control) and the probes B7e, B7a and B7c of several trees on the same
inputs, on the card.

    python -m raytracinggpu_tpu_torch.bench.tiled_design [DIR ...]
        [--rounds N] [--iters N] [--only tiled,pairslope,visits]

Builds the ``pallas_trace.cu`` and ``micro_kernel.cu`` of each ``csrc/``
directory given (this package's when none is; another tree's from ``git
archive``, say), with the flags of ``ops/_kernels.py``, one nvcc process
per source, all started together, into ``_build/`` (``pairs_design``'s
build); each source must keep the C interface of ``ops/_kernels``.  Then:

- ``tiled``: captures the depth-1 casts of B5 and B6 that the pallas
  headline frame (``array_bvh``, 512x512, spp 32, depth 5,
  ``traversal="pallas"``) launches first, at the preset's subgroup (64)
  and at 16 (the same frame), and times each tree's B5 and B6 on them
  with CUDA events: ms, ps a Moller-Trumbore test, the shares of the
  bound and of the no-FMA floor, beside the registers and shared memory
  ptxas reports;
- ``pairslope``: times each tree's B7e on ``bench/micro_kernel.py``'s
  inputs at 131,072 rays and 31 tiles and at 524,288 rays and 40 tiles,
  at subgroups 8, 16, 32 and 64 and L = 0, 1, 2 and 4 pairs a subgroup,
  replayed from CUDA graphs: ms, ps a test (and beyond the L = 0
  intercept) and the share of the bound;
- ``visits``: times each tree's B7a (L = 0, 1, 2, 4 and 8 tiles a
  subgroup) and B7c (all true, a quarter true, and none true: eight
  skips a warp and no visit) on the same inputs at the same two sizes,
  replayed from CUDA graphs: ms, ps a test, the shares of the bound and
  of the no-FMA floor, and each tree's line through its B7a times over
  L = 1 to 8 (``micro_kernel.visit_fit``: the fixed cost of a cast and
  the cost of a visit), from the faster of its turns.

The trees run in turns: in the order given, then reversed, ``--rounds``
times in all (two: A, B, B, A).  Every output must equal the plain
version's bit for bit.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import math

import torch

from raytracinggpu_tpu_torch.bench import pairs_design as pd
from raytracinggpu_tpu_torch.ops import _kernels

TILED = ("pallas_closest", "pallas_shadow")
PAIR_SIZES = ((131072, 31), (524288, 40))  # (rays, tiles) of the probes
PAIR_SUBGS = (8, 16, 32, 64)
PAIR_LS = (0, 1, 2, 4)
PARTS = ("tiled", "pairslope", "visits")
# the probe kernels whose ptxas resources are printed
_PROBE_KERNELS = ("pair_slope", "visit_kernel", "tile_slope",
                  "uniform_branch")
_SPAN_S = 2e-3          # a replayed graph spans at least this


def _libs(path_tiled, path_micro):
    """(tiled library, probe library) with their C signatures set."""
    p, i, fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    tiled = ctypes.CDLL(path_tiled)
    for name in TILED:
        cfun, _, dts, _ = _kernels._SPECS[name]
        fn = getattr(tiled, cfun)
        fn.argtypes = [p, p, p, i, i, i, i, i, fl] + [p] * len(dts) + [p]
        fn.restype = i
    micro = ctypes.CDLL(path_micro)
    for cfun, args in (
            ("rt_probe_pair_slope", [p, p, p, i, i, i, i, p, p]),
            ("rt_probe_tile_slope", [p, p, p, i, i, i, i, p, p]),
            ("rt_probe_uniform_branch", [p, p, p, i, i, i, i, i, p, p])):
        fn = getattr(micro, cfun)
        fn.argtypes = args
        fn.restype = i
    return tiled, micro


def _ok(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def launch_tiled(lib, name, rfT, fields, lists, eps, subg):
    """One launch of tiled kernel ``name`` from one tree's library (not
    counted in ``_kernels.LAUNCHES``); returns the output tuple."""
    cfun, rows, dts, kind = _kernels._SPECS[name]
    R, Tp, L = _kernels._check(rfT, fields, lists, subg, _kernels.TILE_T,
                               rows, kind)
    outs = tuple(torch.empty(R, dtype=dt, device=rfT.device) for dt in dts)
    _ok(getattr(lib, cfun)(
        rfT.data_ptr(), fields.data_ptr(), lists.data_ptr(), R, Tp, L, subg,
        _kernels.TILE_T, max(float(eps), 0.0), *(o.data_ptr() for o in outs),
        torch.cuda.current_stream().cuda_stream), name)
    return outs


def launch_pair_slope(lib, pairs, rf, tri, subg):
    """One launch of B7e from one tree's library; returns t (R / 128,
    128)."""
    R, Tp = rf.shape[0], tri.shape[1]
    t = torch.empty((R // _kernels.TILE_T, _kernels.TILE_T),
                    dtype=torch.float32, device=rf.device)
    _ok(lib.rt_probe_pair_slope(
        pairs.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp,
        pairs.shape[1], subg, t.data_ptr(),
        torch.cuda.current_stream().cuda_stream), "rt_probe_pair_slope")
    return t


def launch_visits(lib, case):
    """One launch of B7a or B7c (``case`` of ``micro_kernel.cases``) from
    one tree's library; returns t (R / 128, 128)."""
    rows, rf, tri = case["args"]
    R, Tp = rf.shape[0], tri.shape[1]
    t = torch.empty((R // _kernels.TILE_T, _kernels.TILE_T),
                    dtype=torch.float32, device=rf.device)
    head = (rows.data_ptr(), rf.data_ptr(), tri.data_ptr(), R, Tp,
            rows.shape[1], _kernels.PROBE_SUBG)
    tail = (t.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if case["probe"] == "slope":
        _ok(lib.rt_probe_tile_slope(*head, *tail), "rt_probe_tile_slope")
    else:
        _ok(lib.rt_probe_uniform_branch(*head, _kernels.PROBE_FIXED, *tail),
            "rt_probe_uniform_branch")
    return t


def mt_tests(lists, subg: int) -> int:
    """Moller-Trumbore tests of a tiled cast: each ray tests the 128 slots
    of each of the first count ids of its subgroup's list (at most L - 1;
    the pallas culling lists only tiles of the table)."""
    count = lists[:, 0].clamp(0, lists.shape[1] - 1)
    return int(count.sum()) * _kernels.TILE_T * subg


def tiled_casts(device, subg):
    """(config, table, {kernel: (rfT, lists)}): the depth-1 casts of B5 and
    B6 that the pallas headline frame launches first, at ``subg``."""
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5, traversal="pallas",
                               pallas_subgroup=subg)
    kept = pd.first_casts(tables, cfg, TILED, device)
    return cfg, tables.pallas_mesh, {k: v[1] for k, v in kept.items()}


def _turns(trees, rounds):
    """The trees in turns: as given, then reversed, ``rounds`` times."""
    for n in range(rounds):
        yield from (trees if n % 2 == 0 else trees[::-1])


def run(trees, rounds=2, iters=20, device="cuda", card="", parts=PARTS):
    """Times every tree; returns {(kernel, case): {tree: [ms, ...]}}: a
    wrapper of ``TILED`` at a subgroup, "B7e" at (rays, subgroup, L), or
    the label of a B7a or B7c case (``micro_kernel.cases``) at its rays."""
    from raytracinggpu_tpu_torch.bench import micro_kernel as mk
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    built = pd.build_libraries([(v, f) for v in trees
                                for f in ("pallas_trace.cu",
                                          "micro_kernel.cu")])
    libs = {v: _libs(built[v, "pallas_trace.cu"][0],
                     built[v, "micro_kernel.cu"][0]) for v in trees}
    for v in trees:
        res = pd.kernel_resources(built[v, "pallas_trace.cu"][1])
        res.update((k, r) for k, r in pd.kernel_resources(
            built[v, "micro_kernel.cu"][1]).items()
            if any(p in k for p in _PROBE_KERNELS))
        print(f"{pd.label(v)}: ptxas (registers, smem bytes) "
              + ", ".join(f"{k}: {r}" for k, r in sorted(res.items())),
              flush=True)
    times = {}
    for subg in ((64, 16) if "tiled" in parts else ()):
        cfg, tab, casts = tiled_casts(device, subg)
        for k in TILED:
            rfT, lists = casts[k]
            args = (rfT, tab.fields, lists, cfg.eps_leaf, subg)
            want = getattr(pat, f"{k}_plain")(*args)
            want = want if isinstance(want, tuple) else (want,)
            for v, (lib, _) in libs.items():
                got = launch_tiled(lib, k, *args)
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise SystemExit(f"tiled_design: {pd.label(v)}'s {k} at "
                                     f"subgroup {subg} differs from the "
                                     "plain version")
            tests = mt_tests(lists, subg)
            bound_ms = tests * pd.FLOP_PER_TEST / pd.PEAK_F32_FLOPS * 1e3
            floor_ms = tests * pd.FLOP_PER_TEST / pd.NO_FMA_OPS_S * 1e3
            row = times.setdefault((k, subg), {v: [] for v in trees})
            for v in _turns(list(trees), rounds):
                lib = libs[v][0]
                ms = timed(lambda: launch_tiled(lib, k, *args), iters) * 1e3
                row[v].append(ms)
                print(f"{k} depth-1 cast ({rfT.shape[1]} rays, subgroup "
                      f"{subg}, {tests} MT tests), {pd.label(v)}: {ms:.4f} "
                      f"ms, {ms * 1e9 / tests:.3f} ps a test, bound "
                      f"{bound_ms:.4f} ms ({bound_ms / ms:.1%}), no-FMA "
                      f"floor {floor_ms:.4f} ms ({floor_ms / ms:.1%}), "
                      f"bitwise the plain version, on {card}", flush=True)

    for R, n_tiles in (PAIR_SIZES if "pairslope" in parts else ()):
        rf, tri = mk.cast_inputs(R, n_tiles, 0, device)
        for subg in PAIR_SUBGS:
            for L in PAIR_LS:
                pairs = mk.pair_lists(R, n_tiles, subg, L, device)
                want = mk.pair_slope_plain(pairs, rf, tri, subg)
                calls = {v: (lambda lib=lib: launch_pair_slope(
                    lib, pairs, rf, tri, subg)) for v, (_, lib) in libs.items()}
                for v, fn in calls.items():
                    if not torch.equal(fn(), want):
                        raise SystemExit(f"tiled_design: {pd.label(v)}'s B7e "
                                         f"differs from the plain version at "
                                         f"{R} rays, subgroup {subg}, L {L}")
                tests = R * L * _kernels.TILE_T
                bound_ms = tests * pd.FLOP_PER_TEST / pd.PEAK_F32_FLOPS * 1e3
                est = timed(calls[trees[0]], iters, graph=True)
                n = max(iters, min(100 * iters, math.ceil(_SPAN_S / est)))
                row = times.setdefault(("B7e", (R, subg, L)),
                                       {v: [] for v in trees})
                for v in _turns(list(trees), rounds):
                    ms = timed(calls[v], n, graph=True) * 1e3
                    row[v].append(ms)
                    line = (f"B7e {R} rays, {n_tiles} tiles, subgroup {subg}, "
                            f"L {L}, {pd.label(v)}: {ms:.4f} ms replayed "
                            f"({n} launches a graph)")
                    if L:
                        base = times[("B7e", (R, subg, 0))][v][-1]
                        line += (f", {ms * 1e9 / tests:.3f} ps a test "
                                 f"({(ms - base) * 1e9 / tests:.3f} beyond "
                                 f"the L 0 intercept), bound {bound_ms:.4f} "
                                 f"ms ({bound_ms / ms:.1%})")
                    print(f"{line}, bitwise the plain version, on {card}",
                          flush=True)

    for R, n_tiles in (PAIR_SIZES if "visits" in parts else ()):
        todo = list(mk.cases(R, n_tiles, device, only=("slope", "branch")))
        mask, rf, tri = todo[-1]["args"]
        todo.append(dict(todo[-1], label="scalar_branch[none_true]",
                         name="none_true", visits=0, tests=0,
                         args=(torch.zeros_like(mask), rf, tri),
                         nbytes=4 * (mask.numel() + R)))
        Ls = []
        for c in todo:
            if c["probe"] == "slope":
                Ls.append(c["L"])
            want = c["plain"](*c["args"])
            calls = {v: (lambda lib=lib, c=c: launch_visits(lib, c))
                     for v, (_, lib) in libs.items()}
            for v, fn in calls.items():
                if not torch.equal(fn(), want):
                    raise SystemExit(f"tiled_design: {pd.label(v)}'s "
                                     f"{c['label']} differs from the plain "
                                     f"version at {R} rays")
            tests = c["tests"]
            bound_ms = max(tests * pd.FLOP_PER_TEST / pd.PEAK_F32_FLOPS,
                           c["nbytes"] / pd.PEAK_BYTES_S) * 1e3
            floor_ms = tests * pd.FLOP_PER_TEST / pd.NO_FMA_OPS_S * 1e3
            est = timed(calls[trees[0]], iters, graph=True)
            n = max(iters, min(100 * iters, math.ceil(_SPAN_S / est)))
            row = times.setdefault((c["label"], R), {v: [] for v in trees})
            for v in _turns(list(trees), rounds):
                ms = timed(calls[v], n, graph=True) * 1e3
                row[v].append(ms)
                line = (f"{c['label']} {R} rays, {n_tiles} tiles, "
                        f"{pd.label(v)}: {ms:.4f} ms replayed ({n} launches "
                        f"a graph)")
                if tests:
                    line += (f", {ms * 1e9 / tests:.3f} ps a test, bound "
                             f"{bound_ms:.4f} ms ({bound_ms / ms:.1%}), "
                             f"no-FMA floor {floor_ms:.4f} ms "
                             f"({floor_ms / ms:.1%})")
                print(f"{line}, bitwise the plain version, on {card}",
                      flush=True)
        for v in trees:
            secs = [min(times[(f"tile_slope L={L}", R)][v]) / 1e3
                    for L in Ls]
            print(mk.fit_line(f"B7a {R} rays, {n_tiles} tiles, "
                              f"{pd.label(v)}", Ls, secs, R)
                  + f", on {card}", flush=True)
    return times


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", default=[_kernels.CSRC],
                    help="csrc/ directories whose kernels to time")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated subset of {','.join(PARTS)}")
    a = ap.parse_args(argv)
    parts = a.only.split(",")
    if set(parts) - set(PARTS):
        ap.error(f"unknown parts {sorted(set(parts) - set(PARTS))}")
    if not torch.cuda.is_available():
        raise SystemExit("tiled_design: needs a CUDA device")
    run(a.csrc, a.rounds, a.iters, card=card_line(), parts=parts)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
