"""The compaction ladder's cost on the card: the default pairs frames (the
ladder on) against the same frames with every tier at 0 (each cast at
full width, the same image bit for bit), in turns in one process.

    python -m raytracinggpu_tpu_torch.bench.ladder [--only PARTS]

PARTS, comma-separated (all by default):

- ``frames``: the headline frame (``array_bvh``, 512x512, spp 32, depth
  5) and the 200,000-triangle soup of ``bench/big_mesh.py`` (512x512,
  spp 4, depth 2, its key over unions of 32 tiles): one warm-up frame
  each way, then FRAMES frames each way in turns (round i starts with the
  i-th way, seed i + 1; the two frames of a round must be equal): Mray/s
  as median [min, max], and the host's wait for the active counts a
  frame;
- ``profile``: the headline frame, PROFILED each way in turns: the union of its
  kernels' device intervals (``utils/profiling.device_kernels``), the
  busy share (that over an unprofiled frame's wall time) and the kernels
  a frame;
- ``loops``: ``run_loop`` of the realtime preset (512x512, spp 20, depth
  3), unanimated and with ``animate_mesh``, LOOPS loops of LOOP_FRAMES
  frames each way in turns: ms a frame, the wall over the loop;
- ``stages``: the headline's and the realtime frame's depth-1 and depth-2
  casts and the soup's depth-1 casts, replayed through the public mesh
  queries with the arguments the frame gave them.  The functions of
  ``ops/pairs_trace.py`` that the cast runs (STAGES: the key, the sort,
  the gather and culling (``compact_bits``: the C rays' rows from the
  sorted keys and their culling, one launch), the kernel on the C rays,
  the scatter; on a cast that
  overflows every tier, the key, the live rows, the culling and the
  kernel) are each timed alone between CUDA events
  (``utils/profiling.stage_timers``), beside the rows, the culling and
  the kernel of the same cast at full width; the host's wait for the
  count is read with the cast unsynchronised.

Every line carries the card's name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time
from collections import Counter

import torch

HEADLINE = dict(width=512, height=512, spp=32, max_depth=5)
SOUP_FRAME = dict(width=512, height=512, spp=4, max_depth=2)
SOUP_TRIS = 200_000
FRAMES = 6        # timed frames each way
PROFILED = 5      # profiled frames each way
LOOPS = 3         # realtime loops each way
LOOP_FRAMES = 6
STAGE_ITERS = 10
PARTS = ("frames", "profile", "loops", "stages")
_PT = "raytracinggpu_tpu_torch.ops.pairs_trace"
# the function of ops/pairs_trace.py that each stage of a cast times
STAGES = {"_compact_key": "key", "_ray_feature_rows": "rows",
          "_live_rows": "rows", "_compact_sort": "sort",
          "compact_bits": "gather and culling", "_bits": "culling",
          "pairs_closest": "kernel", "pairs_closest_smooth": "kernel",
          "pairs_closest_idx": "kernel", "pairs_shadow": "kernel",
          "scatter": "scatter"}
# a compacted cast's rows are built at its C lanes, and culled, by the
# gather
COMPACTED = ("key", "sort", "gather and culling", "kernel", "scatter")
OVERFLOWED = ("key", "rows", "culling", "kernel")  # no tier holds the cast
FULL_WIDTH = ("rows", "culling", "kernel")


def ladder_off(cfg):
    """``cfg`` with every tier of the compaction ladder at 0: each pairs
    cast at full width (the frame is the same)."""
    return dataclasses.replace(cfg, pairs_compact=0.0, pairs_compact2=0.0,
                               pairs_compact3=0.0)


class TierLog:
    """Record every ladder cast while active: query (``closest`` or
    ``shadow``), depth, the cast's padded rays R, active count n, the tiers,
    the tier taken C (0: full width) and the host's seconds in ``_tier``
    (the wait for the count).  Wraps the functions it reads through, and
    puts them back on exit."""

    def __init__(self):
        self.log = []

    def __enter__(self):
        from raytracinggpu_tpu_torch.integrator import wavefront as wf
        from raytracinggpu_tpu_torch.ops import pairs_trace as pt

        # the cast being run: its depth, its query and its rays
        self.here = here = {"depth": -1, "query": "?", "R": 0}
        self._saved = [(m, a, getattr(m, a)) for m, a in (
            (wf, "depth_configs"), (wf, "_depth_step"),
            (wf, "intersect_tris_pairs"), (wf, "intersect_tris_pairs_shadow"),
            (wf, "intersect_tris_pallas"), (wf, "intersect_tris_shadow"),
            (pt, "_compact_key"), (pt, "_tier"))]
        f = {a: fn for _, a, fn in self._saved}

        def depth_configs(*a):
            here["depth"] = -1
            return f["depth_configs"](*a)

        def depth_step(*a):
            here["depth"] += 1
            return f["_depth_step"](*a)

        def query(name, fn):
            def call(*a, **k):
                here["query"] = name
                return fn(*a, **k)
            return call

        def key(O, *a):
            here["R"] = O.x.shape[0]
            return f["_compact_key"](O, *a)

        def tier(tiers, count):
            t0 = time.perf_counter()
            C = f["_tier"](tiers, count)
            wait = time.perf_counter() - t0
            self.log.append(dict(query=here["query"], depth=here["depth"],
                                 R=here["R"], n=int(count[0]),
                                 tiers=tuple(tiers), C=C, wait=wait))
            return C

        wf.depth_configs, wf._depth_step = depth_configs, depth_step
        wf.intersect_tris_pairs = query("closest", f["intersect_tris_pairs"])
        wf.intersect_tris_pairs_shadow = query(
            "shadow", f["intersect_tris_pairs_shadow"])
        # the tiled traversal's casts, labelled alike (no ladder)
        wf.intersect_tris_pallas = query("closest",
                                         f["intersect_tris_pallas"])
        wf.intersect_tris_shadow = query("shadow", f["intersect_tris_shadow"])
        pt._compact_key, pt._tier = key, tier
        return self

    def __exit__(self, *exc):
        for m, a, fn in self._saved:
            setattr(m, a, fn)

    def summary(self) -> list[str]:
        """One line per (query, depth): casts, the tiers taken, n / R."""
        groups = {}
        for e in self.log:
            groups.setdefault((e["depth"], e["query"]), []).append(e)
        out = []
        for (d, q), es in sorted(groups.items()):
            share = [e["n"] / e["R"] for e in es]
            took = Counter(e["C"] for e in es)
            out.append(
                f"depth {d} {q}: {len(es)} casts of {es[0]['R']} rays, tiers "
                f"{list(es[0]['tiers'])}, taken "
                + ", ".join(f"{'full width' if C == 0 else C} x{k}"
                            for C, k in sorted(took.items()))
                + f"; n_act / R {min(share):.4f} to {max(share):.4f} (mean "
                f"{sum(share) / len(share):.4f}); host wait "
                f"{sum(e['wait'] for e in es) * 1e3:.3f} ms")
        return out


def median(xs) -> float:
    ys = sorted(xs)
    n = len(ys)
    return ys[n // 2] if n % 2 else (ys[n // 2 - 1] + ys[n // 2]) / 2


def spread(xs) -> str:
    """median [min, max] of a list."""
    return (f"median {median(xs):.4f} [{min(xs):.4f}, {max(xs):.4f}] "
            f"(n={len(xs)})")


def turns(i: int, labs=("on", "off")):
    """The ways in turn: round i starts with the i-th."""
    k = i % len(labs)
    return labs[k:] + labs[:k]


def _same(a, b) -> bool:
    """Two frames' (image, TraceStats) bitwise equal."""
    return torch.equal(a[0], b[0]) and all(
        torch.equal(x, y) for x, y in zip(a[1], b[1]))


def build_scenes(device, parts) -> dict:
    """{name: (cfg, tables, frame(cfg, seed))} of the scenes the parts
    run: ``headline`` and ``soup`` frames, ``realtime`` and ``animated``
    loop frame 1."""
    from raytracinggpu_tpu_torch.api import Renderer
    from raytracinggpu_tpu_torch.bench.big_mesh import soup_obj
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render import realtime as rt
    from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    def frames_of(cfg, tables):
        cam = Camera.default(cfg, device)
        return (cfg, tables, lambda c, seed: render_frame(
            tables, c, cam, PRNGKey(seed, device)))

    def loop_frame(cfg, tables):
        return (cfg, tables, lambda c, seed: rt.step(
            tables, c, rt.init_state(c, tables, seed=seed)))

    out = {"headline": frames_of(*build_preset("array_bvh", device,
                                               **HEADLINE))}
    if {"frames", "stages"} & set(parts):
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "soup.obj")
            soup_obj(path, SOUP_TRIS)
            r = Renderer("array_bvh", obj_path=path, bvh_builder="lbvh",
                         device=device, **SOUP_FRAME)
        if r.scene.pairs_mesh is None:
            raise RuntimeError("the soup fell back off the pairs tables")
        out["soup"] = frames_of(r.cfg, r.scene)
    if {"loops", "stages"} & set(parts):
        out["realtime"] = loop_frame(*build_preset("realtime", device))
    if "loops" in parts:
        out["animated"] = loop_frame(*build_preset("realtime", device,
                                                   animate_mesh=True))
    return out


def frames_part(scenes, n: int, card: str) -> None:
    from raytracinggpu_tpu_torch.render.pipeline import rays_per_frame

    for name in ("headline", "soup"):
        cfg, _, frame = scenes[name]
        cfgs = {"on": cfg, "off": ladder_off(cfg)}
        for lab in ("off", "on"):
            frame(cfgs[lab], 0)  # warm-up
        sec, wait = {"on": [], "off": []}, []
        for i in range(n):
            got = {}
            for lab in turns(i):
                torch.cuda.synchronize()
                with TierLog() as log:
                    t0 = time.perf_counter()
                    got[lab] = frame(cfgs[lab], 1 + i)
                    torch.cuda.synchronize()
                    sec[lab].append(time.perf_counter() - t0)
                if lab == "on":
                    wait.append(sum(e["wait"] for e in log.log) * 1e3)
            if not _same(got["on"], got["off"]):
                raise RuntimeError(f"{name} seed {1 + i}: the frame with the "
                                   "ladder on differs from the frame with "
                                   "it off")
        mr = {lab: [rays_per_frame(cfg) / s / 1e6 for s in ss]
              for lab, ss in sec.items()}
        for lab in ("on", "off"):
            print(f"ladder {name} {lab}: Mray/s {spread(mr[lab])}; on {card}")
        print(f"ladder {name}: on / off median Mray/s "
              f"{median(mr['on']) / median(mr['off']):.4f}; the host's wait "
              f"for the counts, ms a frame {spread(wait)}; the frames of "
              "each seed bitwise equal")


def profile_part(scenes, n: int, card: str, device) -> None:
    from raytracinggpu_tpu_torch.utils.profiling import device_kernels, wall_ms

    cfg, _, frame = scenes["headline"]
    cfgs = {"on": cfg, "off": ladder_off(cfg)}
    kms, busy, kernels = ({"on": [], "off": []} for _ in range(3))
    for i in range(n):
        for lab in turns(i):
            fms = wall_ms(lambda: frame(cfgs[lab], 1), device)
            k = device_kernels(lambda: frame(cfgs[lab], 1))
            if k["kernels"] == 0:
                raise RuntimeError("the profiler saw no kernel in the "
                                   "headline frame")
            kms[lab].append(k["kernel_ms"])
            busy[lab].append(k["kernel_ms"] / fms)
            kernels[lab].append(k["kernels"])
    for lab in ("on", "off"):
        print(f"ladder headline {lab}: kernel-device ms a frame (union) "
              f"{spread(kms[lab])}, busy {spread(busy[lab])}, kernels a "
              f"frame {sorted(set(kernels[lab]))}; on {card}")


def loops_part(scenes, n: int, card: str) -> None:
    from raytracinggpu_tpu_torch.render import realtime as rt

    for name in ("realtime", "animated"):
        cfg, tables, _ = scenes[name]
        cfgs = {"on": cfg, "off": ladder_off(cfg)}
        ms = {"on": [], "off": []}
        rt.run_loop(tables, cfg, 1, seed=0, print_every=0)  # warm-up
        for i in range(n):
            for lab in turns(i):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rt.run_loop(tables, cfgs[lab], LOOP_FRAMES, seed=0,
                            print_every=0)
                torch.cuda.synchronize()
                ms[lab].append((time.perf_counter() - t0) / LOOP_FRAMES * 1e3)
        for lab in ("on", "off"):
            print(f"ladder {name} loop {lab}: ms a frame (wall over "
                  f"{LOOP_FRAMES}-frame loops) {spread(ms[lab])}; on {card}")
        print(f"ladder {name} loop: on / off median ms a frame "
              f"{median(ms['on']) / median(ms['off']):.4f}")


def capture_queries(frame, n: int) -> list:
    """Run frame() keeping (query name, function, args, kwargs) of its
    first ``n`` pairs mesh queries, in call order (at each depth the
    closest cast, then the shadow cast)."""
    from raytracinggpu_tpu_torch.integrator import wavefront as wf

    kept, saved = [], {}

    def keeping(name, fn):
        def call(*a, **k):
            if len(kept) < n:
                kept.append((name, fn, a, k))
            return fn(*a, **k)
        return call

    for name, attr in (("closest", "intersect_tris_pairs"),
                       ("shadow", "intersect_tris_pairs_shadow")):
        saved[attr] = getattr(wf, attr)
        setattr(wf, attr, keeping(name, saved[attr]))
    try:
        frame()
    finally:
        for attr, fn in saved.items():
            setattr(wf, attr, fn)
    return kept


def stage_ms(query, device) -> dict:
    """{stage: mean ms a cast} of STAGE_ITERS synchronised runs of
    ``query()``, each stage between CUDA events."""
    from raytracinggpu_tpu_torch.utils.profiling import stage_timers

    query()  # warm-up
    with stage_timers(device, [(_PT, f) for f in STAGES], events=True) as st:
        for _ in range(STAGE_ITERS):
            query()
    ms = {}
    for f, (t, _) in st.items():
        ms[STAGES[f]] = ms.get(STAGES[f], 0.0) + t / STAGE_ITERS
    return ms


def stages_part(scenes, card: str, device) -> None:
    for name, depths in (("headline", (1, 2)), ("realtime", (1, 2)),
                         ("soup", (1,))):
        cfg, _, frame = scenes[name]
        kept = capture_queries(lambda: frame(cfg, 0), 2 * (max(depths) + 1))
        for i, (query, fn, a, k) in enumerate(kept):
            if i // 2 not in depths:
                continue
            on = lambda: fn(*a, **k)
            off = lambda: fn(*a, **dict(k, compact=0.0, compact2=0.0,
                                        compact3=0.0))
            with TierLog() as log:  # unsynchronised: the host's wait
                for _ in range(STAGE_ITERS):
                    on()
                torch.cuda.synchronize()
            e = log.log[0]
            wait = sum(x["wait"] for x in log.log) / len(log.log) * 1e3
            t_on, t_off = stage_ms(on, device), stage_ms(off, device)
            want = COMPACTED if e["C"] else OVERFLOWED
            if any(s not in t_on for s in want):
                raise RuntimeError(f"{name} depth {i // 2} {query}: stages "
                                   f"{sorted(t_on)} ran, expected {want}")
            line = (f"ladder stages, {name} depth {i // 2} {query} cast: R "
                    f"{e['R']}, n_act {e['n']} ({e['n'] / e['R']:.4f}), "
                    f"tiers {list(e['tiers'])}, taken "
                    f"{e['C'] or 'full width'}; ms a cast: ")
            line += ", ".join(f"{s} {t_on[s]:.4f}" for s in want)
            line += (f" (sum {sum(t_on[s] for s in want):.4f}), the host's "
                     f"wait {wait:.4f}; at full width: ")
            line += ", ".join(f"{s} {t_off[s]:.4f}" for s in FULL_WIDTH)
            line += f" (sum {sum(t_off[s] for s in FULL_WIDTH):.4f})"
            print(f"{line}; on {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PARTS),
                    help=f"comma-separated parts of {PARTS}")
    args = ap.parse_args(argv)
    parts = [p for p in args.only.split(",") if p]
    if any(p not in PARTS for p in parts):
        ap.error(f"--only takes parts of {PARTS}")
    if not torch.cuda.is_available():
        print("ladder: no CUDA device", file=sys.stderr)
        return 1
    from raytracinggpu_tpu_torch.bench._timing import card_line

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    scenes = build_scenes(device, parts)
    print(f"scenes {sorted(scenes)} built in {time.perf_counter() - t0:.2f} s")
    for part in parts:
        t0 = time.perf_counter()
        if part == "frames":
            frames_part(scenes, FRAMES, card)
        elif part == "profile":
            profile_part(scenes, PROFILED, card, device)
        elif part == "loops":
            loops_part(scenes, LOOPS, card)
        else:
            stages_part(scenes, card, device)
        print(f"part {part}: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
