"""The culling kernels of several trees on the same casts, on the card.

    python -m raytracinggpu_tpu_torch.bench.cull_design [DIR ...]

Builds the ``cull.cu`` of each ``csrc/`` directory given (this package's
when none is; another tree's from ``git archive``, say) with the flags of
``ops/_kernels.py``, one nvcc process a source, all started together
(``bench/pairs_design.build_libraries``); each source must export
``rt_pair_bits`` and ``rt_compact_key`` with the C interface of
``ops/_kernels.load``, and a source that also exports ``rt_pair_bits_k``
and ``rt_compact_key_k`` (rays a thread forced: 1, 2 or 4) is timed at
each of those too; a source that exports ``rt_tile_lists`` and
``rt_tile_lists_k`` (the tiled culling) is timed on the tiled casts of
TILE_ROWS too.  Then keeps the culling calls that the main-path frames
make (``capture``: the headline frame, ``array_bvh`` 512x512 spp 32 depth
5, with the ladder off for its depth-1 full-width casts and on for a
compacted one and the key; the 200,000-triangle soup of
``bench/big_mesh.py``, 512x512 spp 4 depth 2, its depth-1 cast and key)
and the tiled culling's calls of the same two frames through
``traversal="pallas"`` (their depth-1 closest casts), and, on each,
checks every library's kernel bitwise against the plain version and
times it with CUDA events, replayed from a CUDA graph and eager, the
trees in turns (each row twice: the trees in order, then reversed),
beside ``bench/cull.call_bound``'s bound and no-FMA floor.  On the tiled
casts it also times this tree's ``rt_pair_bits`` over the valid tile
boxes as members (the words of ``rt_tile_lists`` alone, with no rows):
the rows kernel's and its launch's share is the difference.
Last, the SASS instructions a slab test of each kernel (``cuobjdump
-sass``: the innermost loop that holds the slab tests, over its FMUL / 6,
a slab test having six products).  Every line carries the card's name and
power limit.  Needs a CUDA device, nvcc and cuobjdump.
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

FORCED = (1, 2, 4)  # rays a thread of the *_k entry points
GRAPH_ITERS, EAGER_ITERS = 50, 20
# (row, frame, kernel, label of the call as TierLog names it)
ROWS = (("cat depth-1 closest, full width", "headline, the ladder off",
         "pair_bits", "depth 1 closest"),
        ("cat depth-1 shadow, full width", "headline, the ladder off",
         "pair_bits", "depth 1 shadow"),
        ("cat depth-1 closest, compacted", "headline", "pair_bits",
         "depth 1 closest"),
        ("cat depth-1 closest", "headline", "compact_key", "depth 1 closest"),
        ("soup depth-1 closest", "soup", "pair_bits", "depth 1 closest"),
        ("soup depth-1 closest", "soup", "compact_key", "depth 1 closest"))
# (row, frame) of the tiled culling's timed depth-1 closest casts
TILE_ROWS = (("cat pallas depth-1 closest", "headline, pallas"),
             ("soup pallas depth-1 closest", "soup, pallas"))


def capture(render, n_bits: int, n_keys: int, n_lists: int = 0):
    """Run render() with ops/pairs_trace's ``_pair_bits`` and
    ``_compact_key`` and ops/pallas_trace's ``_block_active_tiles``
    wrapped so that the inputs of their first ``n_bits``, ``n_keys`` and
    ``n_lists`` calls are kept (cloned), each labelled with its depth and
    query as bench/ladder.TierLog tracks them; the wrapped functions are
    the real ones, which launch and count as always, and are put back
    afterwards.  Returns ({"pair_bits": [(label, args)], "compact_key":
    [...], "tile_lists": [...]}, render's result)."""
    from raytracinggpu_tpu_torch.bench.ladder import TierLog
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    kept = {"pair_bits": [], "compact_key": [], "tile_lists": []}

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        return Vec3(*(c.clone() for c in x)) if isinstance(x, Vec3) else x

    with TierLog() as log:
        here = log.here

        def keeping(name, n, fn):
            def call(*args):
                if len(kept[name]) < n:
                    kept[name].append(
                        (f"depth {here['depth']} {here['query']}",
                         tuple(map(clone, args))))
                return fn(*args)
            return call

        saved = pt._pair_bits, pt._compact_key, pat._block_active_tiles
        bits = keeping("pair_bits", n_bits, saved[0])
        pt._pair_bits = lambda O, u, nc, subg, members, cap=None, \
            active=None: bits(O, u, nc, subg, members, cap, active)
        pt._compact_key = keeping("compact_key", n_keys, saved[1])
        lists = keeping("tile_lists", n_lists, saved[2])
        pat._block_active_tiles = lambda O, u, aabb, n_tiles, cap=None, \
            subg=pat.SUBG: lists(O, u, aabb, n_tiles, cap, subg)
        try:
            out = render()
        finally:
            pt._pair_bits, pt._compact_key, pat._block_active_tiles = saved
    return kept, out


def _bind(path):
    """The library at ``path`` with the culling entry points' argtypes;
    (lib, whether it has the *_k entry points)."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"rt_pair_bits": [p] * 7 + [i, p, i, p, p, i, i, i, p],
            "rt_compact_key": [p] * 7 + [i] * 4 + [p, p, i, i, p, p]}
    has_k = all(hasattr(lib, f"{n}_k") for n in sigs)
    if hasattr(lib, "rt_tile_lists_k"):
        sigs["rt_tile_lists"] = [p] * 7 + [i, p, i, i, i, p, p]
    for name in list(sigs):
        if has_k or name == "rt_tile_lists":
            sigs[f"{name}_k"] = sigs[name] + [i]
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args + [p]
        fn.restype = i
    return lib, has_k


def launch(lib, name, args, k=None):
    """One call of kernel ``name`` ("pair_bits", "compact_key" or
    "tile_lists") from ``lib`` on the arguments of
    ``ops/pairs_trace._pair_bits`` or ``_compact_key`` or
    ``ops/pallas_trace._block_active_tiles``, with ``k`` rays a thread
    forced when given (not counted in ``_kernels.LAUNCHES``); returns bits,
    (skey, n_act) or the list rows."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    ptr = lambda x: None if x is None else x.data_ptr()
    st = torch.cuda.current_stream().cuda_stream
    kk = () if k is None else (k,)
    if name == "pair_bits":
        O, u, nc, subg, (boxes, tiles), cap, active = args
        rows, cap, active, R = _kernels._ray_rows(O, u, cap, active)
        out = torch.empty((-(-nc // 32), R // subg), dtype=torch.int32,
                          device=boxes.device)
        fn = lib.rt_pair_bits_k if k else lib.rt_pair_bits
        err = fn(*(x.data_ptr() for x in rows), boxes.data_ptr(),
                 boxes.shape[1], tiles.data_ptr(), boxes.shape[0], ptr(cap),
                 ptr(active), R, subg, nc, out.data_ptr(), *kk, st)
    elif name == "tile_lists":
        O, u, aabb, nt, cap, subg = args
        rows, cap, _, R = _kernels._ray_rows(O, u, cap, None)
        out = torch.empty((R // subg, 1 + nt), dtype=torch.int32,
                          device=aabb.device)
        bits = torch.empty((-(-nt // 32), R // subg), dtype=torch.int32,
                           device=aabb.device)
        fn = lib.rt_tile_lists_k if k else lib.rt_tile_lists
        err = fn(*(x.data_ptr() for x in rows), aabb.data_ptr(),
                 aabb.shape[1], ptr(cap), R, subg, nt, bits.data_ptr(),
                 out.data_ptr(), *kk, st)
    else:
        O, u, boxes, nc, cap, active, valid_n = args
        rows, cap, active, R = _kernels._ray_rows(O, u, cap, active)
        mode, shift = pt._key_mode(nc, R)
        skey = torch.empty(R, dtype=torch.int32, device=boxes.device)
        n_act = torch.empty((), dtype=torch.int64, device=boxes.device)
        out = (skey, n_act)
        fn = lib.rt_compact_key_k if k else lib.rt_compact_key
        err = fn(*(x.data_ptr() for x in rows), boxes.data_ptr(),
                 boxes.shape[1], nc, mode, shift, ptr(cap), ptr(active), R,
                 max(min(int(valid_n), R), 0), skey.data_ptr(),
                 n_act.data_ptr(), *kk, st)
    if err:  # the error's name from the package's library
        _kernels._raise_on(_kernels.load(), err, name)
    return out


def dispatching(name):
    """The function of the port that launches kernel ``name`` on CUDA
    tensors (its plain version on CPU tensors)."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    return {"pair_bits": pt._pair_bits, "compact_key": pt._compact_key,
            "tile_lists": pat._block_active_tiles}[name]


def plain(name, args):
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    if name == "pair_bits":
        return pt.pair_bits_plain(*args)
    if name == "tile_lists":
        return pat.block_active_tiles_plain(*args)
    return pt.compact_key_plain(*args)[:2]


def same(name, got, want) -> bool:
    if name != "compact_key":
        return torch.equal(got, want)
    return torch.equal(got[0], want[0]) and int(got[1]) == int(want[1])


def forced(name, args):
    """The rays a thread (FORCED) that a call can be forced to: for
    pair_bits and tile_lists those dividing its subgroup."""
    subg = {"pair_bits": 3, "tile_lists": 5}.get(name)
    return [k for k in FORCED if subg is None or args[subg] % k == 0]


def hold_index_cases(cases) -> list:
    """Each case of ``bench/cull.index_cases`` through the dispatching
    function of ops/pairs_trace or ops/pallas_trace (the wrapper, rays a
    thread by default, counted in LAUNCHES) and through this package's *_k
    entry points at each of ``forced``: [(label, k or None, bitwise the
    plain version)]."""
    lib = _kernels.load()
    out = []
    for label, name, args, plain_args in cases:
        want = plain(name, plain_args)
        got = dispatching(name)(*args)
        torch.cuda.synchronize()
        out.append((label, None, same(name, got if name != "compact_key"
                                      else got[:2], want)))
        for k in forced(name, args):
            got = launch(lib, name, args, k)
            torch.cuda.synchronize()
            out.append((label, k, same(name, got, want)))
    return out


def graph_nodes(fn) -> list:
    """The node types (libcuda's CUgraphNodeType: 0 a kernel, 2 a
    memset, ...) of one CUDA graph capturing fn(): what one call puts on
    the stream, read from the graph, not from a profiler."""
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(handle, None, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(handle, nodes, ctypes.byref(n)):
        raise RuntimeError("cuGraphGetNodes failed")
    types = []
    for node in nodes:
        t = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        types.append(t.value)
    return types


def frames_calls(device):
    """{frame: kept calls (``capture``)} of the headline frame with the
    ladder off and on, of the soup frame, and of both through the tiled
    traversal."""
    import dataclasses

    from raytracinggpu_tpu_torch.bench.ladder import build_scenes, ladder_off

    scenes = build_scenes(device, ["frames"])
    hcfg, _, head = scenes["headline"]
    scfg, _, soup = scenes["soup"]
    tiled = lambda c: dataclasses.replace(c, traversal="pallas")
    out = {}
    for where, render, n_bits, n_keys, n_lists in (
            ("headline, the ladder off", lambda: head(ladder_off(hcfg), 0),
             4, 0, 0),
            ("headline", lambda: head(hcfg, 0), 6, 4, 0),
            ("soup", lambda: soup(scfg, 0), 4, 2, 0),
            ("headline, pallas", lambda: head(tiled(hcfg), 0), 0, 0, 4),
            ("soup, pallas", lambda: soup(tiled(scfg), 0), 0, 0, 4)):
        out[where] = capture(render, n_bits, n_keys, n_lists)[0]
        torch.cuda.synchronize()
    return out


def _disasm(path):
    """{kernel name (pairs_design._kernel_name): [(address, text)]} of the
    SASS of the library at ``path``."""
    from raytracinggpu_tpu_torch.bench.pairs_design import _kernel_name

    tool = os.path.join(os.path.dirname(_kernels.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(_kernel_name(m.group(1)) or m.group(1), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def slab_sass(instrs):
    """(instructions a slab test, FMNMX a slab test, tests an iteration)
    of the innermost loop (a backward branch with no other inside it) that
    holds the most FMUL, or None; a slab test has six FMUL."""
    addr = [a for a, _ in instrs]
    loops = []
    for i, (a, t) in enumerate(instrs):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) <= a:
            lo = addr.index(int(m.group(1), 16)) if int(
                m.group(1), 16) in addr else None
            if lo is not None:
                loops.append((lo, i))
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                        for l2, h2 in loops)]
    best = None
    for lo, hi in inner:
        body = [t for _, t in instrs[lo:hi + 1]]
        fmul = sum(1 for t in body if re.search(r"\bFMUL\b", t))
        if fmul and (best is None or fmul > best[1]):
            best = (body, fmul)
    if best is None:
        return None
    body, fmul = best
    tests = fmul / 6
    fmnmx = sum(1 for t in body if re.search(r"\bFMNMX\b", t))
    return len(body) / tests, fmnmx / tests, tests


def sass_report(libs, label) -> None:
    for v, (path, _) in libs.items():
        try:
            funcs = _disasm(path)
        except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
            print(f"sass {label(v)}: not read ({e})")
            continue
        for name in sorted(funcs):
            if not any(k in name for k in ("pair_bits", "compact_key")):
                continue
            got = slab_sass(funcs[name])
            nan = sum(1 for _, t in funcs[name] if "FMNMX" in t and "NAN" in t)
            print(f"sass {label(v)} {name}: "
                  + ("innermost slab loop not found" if got is None else
                     f"{got[0]:.2f} instructions a slab test ({got[1]:.2f} "
                     f"FMNMX; {got[2]:g} tests an iteration)")
                  + f"; {nan} FMNMX with NaN propagation in the kernel",
                  flush=True)


def run(sources, card: str, device="cuda") -> dict:
    """Times every source's kernels on the kept calls; returns {(row,
    kernel): {(tree label, k): [graph ms, ...]}}."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.cull import call_bound
    from raytracinggpu_tpu_torch.bench.pairs_design import (
        build_libraries, kernel_resources)

    label = lambda v: ("this tree" if os.path.samefile(v, _kernels.CSRC)
                       else v)
    built = build_libraries([(v, "cull.cu") for v in sources])
    libs = {v: built[v, "cull.cu"] for v in sources}
    bound_libs = {v: _bind(path) for v, (path, _) in libs.items()}
    for v, (_, report) in libs.items():
        res = kernel_resources(report)
        print(f"{label(v)}: " + ", ".join(
            f"{k}: {r} registers, {s} B smem" for k, (r, s) in sorted(
                res.items())))
    calls = frames_calls(device)
    results = {}
    for row, where, name, lab in ROWS:
        args = next(a for la, a in calls[where][name] if la == lab)
        want = plain(name, args)
        torch.cuda.synchronize()
        bound, by, floor = call_bound(name, args, want)
        variants = []
        for v, (lib, has_k) in bound_libs.items():
            for k in ((None, *forced(name, args)) if has_k else (None,)):
                got = launch(lib, name, args, k)
                torch.cuda.synchronize()
                if not same(name, got, want):
                    raise SystemExit(f"cull_design: {label(v)}'s {name} "
                                     f"(k {k}) differs from the plain "
                                     f"version on the {row} cast")
                variants.append((v, lib, k))
        res = results[row, name] = {}
        for order in (variants, variants[::-1]):
            for v, lib, k in order:
                fn = lambda: launch(lib, name, args, k)
                g = timed(fn, GRAPH_ITERS, graph=True) * 1e3
                e = timed(fn, EAGER_ITERS) * 1e3
                res.setdefault((label(v), k), []).append((g, e))
        n_boxes = args[4][0].shape[0] if name == "pair_bits" else args[3]
        for (v, k), ms in res.items():
            g = [x for x, _ in ms]
            print(f"{name} on the {row} cast ({args[0].x.shape[0]} rays, "
                  f"{n_boxes} boxes), {v}, k {k or 'auto'}: graph "
                  f"{', '.join(f'{x:.4f}' for x in g)} ms, eager "
                  f"{', '.join(f'{y:.4f}' for _, y in ms)} ms; bound "
                  f"{bound:.4f} ({by}, {bound / min(g):.1%}), no-FMA floor "
                  f"{floor:.4f} ({floor / min(g):.1%}); bitwise the plain "
                  f"version; on {card}", flush=True)
    for row, where in TILE_ROWS:
        args = next(a for la, a in calls[where]["tile_lists"]
                    if la == "depth 1 closest")
        time_tile_row(row, args, bound_libs, label, results, card)
    sass_report(libs, label)
    return results


def time_tile_row(row, args, bound_libs, label, results, card) -> None:
    """The tiled culling on one kept cast: each library that has
    ``rt_tile_lists`` (and each rays-a-thread), bitwise the plain version,
    timed in turns as ``run``'s rows are, and this tree's ``rt_pair_bits``
    over the valid tile boxes as members (the words alone)."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.cull import call_bound

    name = "tile_lists"
    O, u, aabb, nt, cap, subg = args
    want = plain(name, args)
    torch.cuda.synchronize()
    bound, by, floor = call_bound(name, args, want)
    valid = aabb[:nt, 0] <= aabb[:nt, 3]
    tiles = torch.where(valid, torch.arange(nt, device=aabb.device),
                        -1).to(torch.int32)
    words = (O, u, nt, subg, (aabb[:nt].contiguous(), tiles), cap, None)
    this = _kernels.load()
    variants = [("words alone (rt_pair_bits)", this, "pair_bits", None)]
    for v, (lib, _) in bound_libs.items():
        if not hasattr(lib, "rt_tile_lists_k"):
            continue
        for k in (None, *forced(name, args)):
            got = launch(lib, name, args, k)
            torch.cuda.synchronize()
            if not same(name, got, want):
                raise SystemExit(f"cull_design: {label(v)}'s tile_lists (k "
                                 f"{k}) differs from the plain version on "
                                 f"the {row} cast")
            variants.append((label(v), lib, name, k))
    res = results[row, name] = {}
    for order in (variants, variants[::-1]):
        for v, lib, kern, k in order:
            a = words if kern == "pair_bits" else args
            fn = lambda: launch(lib, kern, a, k)
            g = timed(fn, GRAPH_ITERS, graph=True) * 1e3
            e = timed(fn, EAGER_ITERS) * 1e3
            res.setdefault((v, k), []).append((g, e))
    for (v, k), ms in res.items():
        g = [x for x, _ in ms]
        print(f"tile_lists on the {row} cast ({O.x.shape[0]} rays, "
              f"{int(valid.sum())} valid of {nt} tiles, subgroup {subg}), "
              f"{v}, k {k or 'auto'}: graph "
              f"{', '.join(f'{x:.4f}' for x in g)} ms, eager "
              f"{', '.join(f'{y:.4f}' for _, y in ms)} ms; bound "
              f"{bound:.4f} ({by}, {bound / min(g):.1%}), no-FMA floor "
              f"{floor:.4f} ({floor / min(g):.1%}); bitwise the plain "
              f"version; on {card}", flush=True)


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench._timing import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("csrc", nargs="*", default=[_kernels.CSRC],
                    help="csrc/ directories whose cull.cu to time")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cull_design: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    run(a.csrc, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
