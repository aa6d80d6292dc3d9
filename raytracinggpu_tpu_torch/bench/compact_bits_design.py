"""rt_compact_bits against the parent tree's two launches on the same calls,
on the card.

    python -m raytracinggpu_tpu_torch.bench.compact_bits_design PARENT_CSRC

A compacted pairs cast's rows and culling were two launches,
``rt_compact_rows`` (``csrc/glue.cu``: the live rows of its C source
lanes) then ``rt_pair_bits`` (``csrc/cull.cu``: the culling words of the
C rays those rows hold); this tree's ``rt_compact_bits`` (``csrc/cull.cu``)
gathers, writes the rows and culls in one.  The bench builds this tree's
``cull.cu`` and PARENT_CSRC's ``glue.cu`` and ``cull.cu`` (the ``csrc/`` of
a ``git archive`` of the parent commit, unpacked under the ignored
``.chip_tree/``), with the flags of ``ops/_kernels.py``, one nvcc process
a source, all started together (``bench/pairs_design.build_libraries``),
and loads a second copy of the parent's two libraries from other paths:
the spread two identical libraries show in one process.

It keeps the compacted depth-1 closest and shadow casts of the headline
frame (``array_bvh`` 512x512 spp 32 depth 5, pairs, the ladder on:
``bench/cast_glue.capture``'s compact_bits calls of the first trace) and
holds every way bitwise ``ops/pairs_trace.compact_bits_plain`` on them
(rows, shadow mask, words) and on ``bench/cast_glue.adversarial_calls``'
compacted calls.  The ways: this tree's fused launch (rays a thread as the
wrapper chooses, and forced to 1 and 2 where they divide the subgroup),
the parent's two launches and their copy, and the PyTorch
call, ``torch.index_select`` of the live rows then this tree's
``rt_pair_bits``.  Each is timed with CUDA events replayed from a CUDA
graph (back to back), with the L2 emptied before each call
(``bench/_timing.timed(flush_l2=True)``) and eager, the ways in turns (in
order, then reversed), beside ``bench/cull.call_bound``'s bound and
no-FMA floor.  Every line carries the card's name and power limit.  Needs
a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import sys

import torch

from raytracinggpu_tpu_torch.ops import _kernels

GRAPH_ITERS, COLD_ITERS, EAGER_ITERS = 50, 30, 20
FORCED = (1, 2)  # rt_compact_bits_k takes one or two rays a thread


def _bind(path):
    """The library at ``path`` with the argtypes of the entry points this
    bench calls that it has."""
    lib = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    sigs = {"rt_compact_bits_k": [p] + [i] * 8 + [p],
            "rt_compact_rows": [p, i, i, i, p],
            "rt_pair_bits": [p] * 7 + [i, p, i, p, p, i, i, i, p, p]}
    for name, args in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = i
    return lib


def _copy(path: str) -> str:
    """A second file of the library at ``path`` (dlopen gives it a handle,
    and the card a module, of its own)."""
    other = path[:-3] + "_copy.so"
    if not os.path.isfile(other):
        shutil.copyfile(path, other)
    return other


def _raise(err, name):
    if err:  # the error's name from the package's library
        _kernels._raise_on(_kernels.load(), err, name)


def _outputs(args):
    """Fresh (rows, active or None, bits) of a compact_bits call."""
    keys, C, _, O, _, nc, subg, _, cap, active = args
    dev = keys.device
    nrows = _kernels.ray_row_count(cap, active, "live")
    return (torch.empty((nrows, C), dtype=torch.float32, device=dev),
            None if active is None else torch.empty(C, dtype=torch.bool,
                                                    device=dev),
            torch.empty((-(-nc // 32), C // subg), dtype=torch.int32,
                        device=dev))


def fused(lib, args, outs, k=0):
    """This tree's rt_compact_bits_k (k 0: the wrapper's rays a thread)."""
    keys, C, shift, O, u, nc, subg, (boxes, tiles), cap, active = args
    rows, act, bits = outs
    p = _kernels._pointers(*O, *u, cap, active, keys, boxes, tiles, rows,
                           act, bits)
    _raise(lib.rt_compact_bits_k(
        p, C, (1 << shift) - 1, rows.shape[0], boxes.shape[1],
        boxes.shape[0], subg, nc, k,
        torch.cuda.current_stream().cuda_stream), "compact_bits")
    return outs


def parent(glue, cull, args, outs):
    """The parent's rt_compact_rows then its rt_pair_bits on the rows."""
    keys, C, shift, O, u, nc, subg, (boxes, tiles), cap, active = args
    rows, act, bits = outs
    src = torch.empty(C, dtype=torch.int32, device=keys.device)
    st = torch.cuda.current_stream().cuda_stream
    p = _kernels._pointers(*O, *u, cap, active, keys, rows, src, act)
    _raise(glue.rt_compact_rows(p, C, rows.shape[0], (1 << shift) - 1, st),
           "compact_rows")
    ptr = lambda x: None if x is None else x.data_ptr()
    _raise(cull.rt_pair_bits(
        *(rows[j].data_ptr() for j in (6, 7, 8, 0, 1, 2)), boxes.data_ptr(),
        boxes.shape[1], tiles.data_ptr(), boxes.shape[0],
        None if cap is None else rows[9].data_ptr(), ptr(act), C, subg, nc,
        bits.data_ptr(), st), "pair_bits")
    return outs


def library_call(args):
    """torch.index_select of the live rows at the C lanes, then this
    tree's rt_pair_bits on them (not a way of the port: its yardstick)."""
    from raytracinggpu_tpu_torch.core.vec import Vec3
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    keys, C, shift, O, u, nc, subg, members, cap, active = args
    full = pat.ray_rows_plain(O, u, cap, active, "live")
    src = (keys[:C] & ((1 << shift) - 1)).long()

    def call():
        rows = torch.index_select(full, 1, src)
        act = None if active is None else rows[10] > 0.5
        bits = _kernels.pair_bits(Vec3(rows[6], rows[7], rows[8]),
                                  Vec3(rows[0], rows[1], rows[2]), nc, subg,
                                  members, None if cap is None else rows[9],
                                  act)
        return rows, act, bits
    return call


def headline_calls(device) -> dict:
    """{"closest": args, "shadow": args} of the headline frame's first
    trace's compacted depth-1 casts (compact_bits' arguments)."""
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5)
    kept, _ = cg.capture(lambda: render_frame(
        tables, cfg, Camera.default(cfg, device), PRNGKey(0, device)),
        depths=2)
    torch.cuda.synchronize()
    return {kind: next(a for lab, kd, a in kept["compact_bits"]
                       if lab.startswith(f"trace 0 depth 1 {kind}"))
            for kind in ("closest", "shadow")}


def ways(libs, args):
    """[(name, fn)] of every way on one call: fn() returns its outputs."""
    this, glue, cull, glue2, cull2 = libs
    subg = args[6]
    out = [("fused (this tree)", lambda o=_outputs(args): fused(this, args,
                                                                 o))]
    for k in FORCED:
        if subg % k == 0:
            out.append((f"fused, {k} rays a thread",
                        lambda o=_outputs(args), k=k: fused(this, args, o, k)))
    out += [("parent: rt_compact_rows + rt_pair_bits",
             lambda o=_outputs(args): parent(glue, cull, args, o)),
            ("parent (a second copy of its libraries)",
             lambda o=_outputs(args): parent(glue2, cull2, args, o)),
            ("torch.index_select of the live rows + rt_pair_bits",
             library_call(args))]
    return out


def hold(libs, calls, card) -> None:
    """Every way bitwise compact_bits_plain on every call; SystemExit on a
    difference."""
    from raytracinggpu_tpu_torch.bench.depth_step import flatten, same_bits
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    for label, args in calls:
        want = flatten(pt.compact_bits_plain(*args))
        for name, fn in ways(libs, args):
            got = flatten(fn())
            torch.cuda.synchronize()
            if not same_bits(got, want):
                raise SystemExit(f"compact_bits_design: {name} differs from "
                                 f"the plain version on {label}")
    print(f"compact_bits_design: {len(calls)} calls, every way bitwise "
          f"compact_bits_plain (rows, mask, words) on {card}", flush=True)


def time_rows(libs, calls, card) -> dict:
    """Each way on each headline call, in turns; returns {kind: {way:
    [(graph, L2 emptied, eager ms), ...]}}."""
    from raytracinggpu_tpu_torch.bench._timing import timed
    from raytracinggpu_tpu_torch.bench.cull import call_bound
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    results = {}
    for kind, args in calls.items():
        keys, C, _, _, _, nc, subg, (boxes, _), cap, active = args
        bound, by, floor = call_bound("compact_bits", args,
                                      pt.compact_bits_plain(*args))
        res = results[kind] = {}
        order = ways(libs, args)
        for turn in (order, order[::-1]):
            for name, fn in turn:
                res.setdefault(name, []).append((
                    timed(fn, GRAPH_ITERS, graph=True) * 1e3,
                    timed(fn, COLD_ITERS, graph=True, flush_l2=True) * 1e3,
                    timed(fn, EAGER_ITERS) * 1e3))
        for name, ms in res.items():
            g, c, e = ([m[j] for m in ms] for j in range(3))
            f = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
            print(f"compact_bits {kind} (C {C} of {keys.shape[0]}, subgroup "
                  f"{subg}, {boxes.shape[0]} member boxes of {nc} tiles, cap "
                  f"{cap is not None}, active {active is not None}), {name}: "
                  f"graph {f(g)} ms, L2 emptied {f(c)} ms, eager {f(e)} ms; "
                  f"bound {bound:.4f} ms ({by}; {bound / min(g):.1%}), "
                  f"no-FMA floor {floor:.4f} ms ({floor / min(g):.1%}) on "
                  f"{card}", flush=True)
    return results


def main(argv=None) -> int:
    from raytracinggpu_tpu_torch.bench import cast_glue as cg
    from raytracinggpu_tpu_torch.bench._timing import card_line
    from raytracinggpu_tpu_torch.bench.pairs_design import build_libraries

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", help="the parent tree's csrc/ directory")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compact_bits_design: needs a CUDA device", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    built = build_libraries([(_kernels.CSRC, "cull.cu"),
                             (a.parent, "glue.cu"), (a.parent, "cull.cu")])
    this = built[_kernels.CSRC, "cull.cu"][0]
    glue, cull = built[a.parent, "glue.cu"][0], built[a.parent, "cull.cu"][0]
    libs = tuple(_bind(p) for p in (this, glue, cull, _copy(glue),
                                    _copy(cull)))
    device = torch.device("cuda", 0)
    calls = headline_calls(device)
    hard = [(label, args) for seed in (0, 1)
            for k, label, _, args in cg.adversarial_calls(device, seed=seed)
            if k == "compact_bits" and args[1]]
    hold(libs, [(f"the headline's depth-1 {k} cast", v)
                for k, v in calls.items()] + hard, card)
    time_rows(libs, calls, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
