"""The mesh casts' glue and the trace's backward composite
(``csrc/glue.cu``: ``ray_rows``, ``scatter`` and ``composite``; and a
compacted cast's rows with its culling, ``csrc/cull.cu``'s
``compact_bits``) against their plain versions: the calls a frame makes,
hard inputs, the frames with the plain glue patched in, and each kernel's
bound.

    python -m raytracinggpu_tpu_torch.bench.cast_glue [--size N]

builds the kernels, renders an N x N frame (default 128) of ``array_bvh``
through the pairs traversal (its ladder at every depth) and the pallas
traversal, of ``realtime`` and of ``showcase`` with the glue's calls of
each trace's first depths kept, holds every kernel bit for bit against its
plain version on them and on ``adversarial_calls``, holds each frame
bitwise against the frame with the plain glue patched in, and prints each
check; it exits 1 on a difference and without a card.  ``chip_smoke.py``'s
phase 22 runs the same checks at the main path's size.

The dispatchers and their plain versions (``STAGES``): ``ray_rows``
(``ops/pallas_trace.py``; the pairs casts' ``_ray_feature_rows`` and
``_live_rows`` and the tiled casts' ``_ray_features16`` call it),
``compact_bits`` and ``scatter`` (``ops/pairs_trace.py``) and
``composite`` (``integrator/wavefront.py``).  Their callers look each up
in their own module, so ``plain_glue`` patches the plain versions in by
name and ``capture`` wraps the dispatchers, both through
``bench/_patch.patched``.

``call_bound`` is a call's least time on the card: every input read and
every output written once at the memory rate, or its f64 operations (the
cross product's three multiplies and three adds a lane; the composite's
multiply and add a channel on each diffuse lane of each depth) at the f64
peak, whichever is larger; the f32 operations are left out, but for
``compact_bits``, whose slab tests bound it (``bench/cull.call_bound``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from raytracinggpu_tpu_torch.bench._patch import module, patched
from raytracinggpu_tpu_torch.bench.depth_step import (
    PEAK_BYTES_S,
    PEAK_F64_FLOPS,
    clone,
    flatten,
    max_abs_err,
    nan_lanes,
    same_bits,
)
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pairs_trace import NO_HIT

# kernel -> the dispatchers that launch it (module, name) and the plain
# version patched in for each
STAGES = {
    "ray_rows": (("ops.pairs_trace", "ray_rows",
                  "ops.pallas_trace", "ray_rows_plain"),
                 ("ops.pallas_trace", "ray_rows",
                  "ops.pallas_trace", "ray_rows_plain")),
    "compact_bits": (("ops.pairs_trace", "compact_bits",
                      "ops.pairs_trace", "compact_bits_plain"),),
    "scatter": (("ops.pairs_trace", "scatter",
                 "ops.pairs_trace", "scatter_plain"),),
    "composite": (("integrator.wavefront", "composite",
                   "integrator.wavefront", "composite_plain"),),
}


def plain_glue():
    """A context manager: the plain versions patched in for every
    dispatcher of the glue (the parent's torch-op path: no kernel of
    csrc/glue.cu launches); put back on exit."""
    return patched({(mod, attr): (lambda _, f=getattr(module(pmod), pattr):
                                  f)
                    for entries in STAGES.values()
                    for mod, attr, pmod, pattr in entries})


def _args(kernel, a, k) -> tuple:
    """A dispatcher call's arguments in its full positional order."""
    if kernel == "ray_rows":
        full = dict(zip(("O", "u", "cap", "active", "layout"), a))
        full.update(k)
        return (full["O"], full["u"], full.get("cap"), full.get("active"),
                full.get("layout", "pairs"))
    if kernel == "composite":
        steps, R, device = a
        return tuple(tuple(s) for s in steps), R, device
    return a


def capture(render, depths: int = 3, traces: int = 1):
    """Run render() keeping a copy of the arguments of each glue call made
    by the first ``traces`` traces at depths below ``depths`` (the
    dispatchers run as always; put back afterwards).  Returns ({kernel:
    [(label, kind, args), ...]}, render's result); kind is the ray rows'
    layout, the cast (``closest`` or ``shadow``) of compact_bits and
    scatter, ``composite`` for the composite; labels name the trace, the
    depth, the cast and, for a compacted cast, its width and key mode."""
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt

    kept = {k: [] for k in STAGES}
    here = {"trace": -1, "depth": -1, "query": "?", "mode": 0}

    def counting(field, value=None):
        def wrap(fn):
            def call(*a, **k):
                if field == "trace":
                    here["trace"] += 1
                    here["depth"] = -1
                elif field == "depth":
                    here["depth"] += 1
                else:
                    here["query"] = value
                return fn(*a, **k)
            return call
        return wrap

    def key(fn):
        def call(O, u, aabb, nc, *a):
            here["mode"] = pt._key_mode(nc, O.x.shape[0])[0]
            return fn(O, u, aabb, nc, *a)
        return call

    def keeping(kernel, fn):
        def call(*a, **k):
            t, d = here["trace"], here["depth"]
            if t < traces and (kernel == "composite" or d < depths):
                args = clone(_args(kernel, a, k))
                if kernel == "ray_rows":
                    kind, label = args[4], f"trace {t} depth {d} " \
                        f"{here['query']}"
                elif kernel == "composite":
                    kind, label = "composite", f"trace {t}, {len(a[0])} " \
                        "depths"
                else:
                    kind = here["query"]
                    label = (f"trace {t} depth {d} {kind}, C {args[1]} of "
                             f"{args[0].shape[0]}, key mode {here['mode']}")
                kept[kernel].append((label, kind, args))
            return fn(*a, **k)
        return call

    wrappers = {("integrator.wavefront", "depth_configs"): counting("trace"),
                ("integrator.wavefront", "_depth_step"): counting("depth"),
                ("integrator.wavefront", "_mesh_closest"):
                    counting("query", "closest"),
                ("integrator.wavefront", "_mesh_shadow"):
                    counting("query", "shadow"),
                ("ops.pairs_trace", "_compact_key"): key}
    for kernel, entries in STAGES.items():
        for mod, attr, _, _ in entries:
            wrappers[mod, attr] = (lambda fn, kernel=kernel:
                                   keeping(kernel, fn))
    with patched(wrappers):
        out = render()
    return kept, out


def call(kernel, args, plain: bool) -> list:
    """One call of the kernel (through its dispatcher, on CUDA tensors) or
    of its plain version on ``args`` (a kept call's, in ``_args`` order;
    read, not written); returns its outputs as a flat list of tensors."""
    from raytracinggpu_tpu_torch.integrator import wavefront as wf
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.ops import pallas_trace as pat

    fn = {"ray_rows": (pat.ray_rows, pat.ray_rows_plain),
          "compact_bits": (pt.compact_bits, pt.compact_bits_plain),
          "scatter": (pt.scatter, pt.scatter_plain),
          "composite": (wf.composite, wf.composite_plain)}[kernel][plain]
    if kernel == "composite":
        steps, R, device = args
        return flatten(fn([list(s) for s in steps], R, device))
    return flatten(fn(*args))


def lanes(kernel, args) -> int:
    """The lanes a call covers: R, C, Rp or the trace's R."""
    return {"ray_rows": lambda: args[0].x.shape[0],
            "compact_bits": lambda: args[1],
            "scatter": lambda: args[0].shape[0],
            "composite": lambda: args[1]}[kernel]()


def hold(kept, where: str, err: dict, quiet: bool = False) -> list:
    """Each kept call's kernel against its plain version on the card, bit
    for bit but for NaN payloads (``bench/depth_step.bits``).  Returns
    [(kernel, label, kind, lanes, equal), ...] and raises the largest
    error of each kernel in ``err`` to its max; prints a line a call
    (``quiet``: none)."""
    out = []
    for kernel, calls in kept.items():
        for label, kind, args in calls:
            got = call(kernel, args, plain=False)
            want = call(kernel, args, plain=True)
            torch.cuda.synchronize()
            ok = same_bits(got, want)
            e = 0.0 if ok else max_abs_err(got, want)
            err[kernel] = max(err.get(kernel, 0.0), e)
            n = lanes(kernel, args)
            out.append((kernel, label, kind, n, ok))
            if not quiet:
                print(f"cast glue {where} {label} {kind}: {kernel} on {n} "
                      f"lanes ({nan_lanes(want)} with a NaN), {len(got)} "
                      "outputs: "
                      + ("bitwise equal" if ok else f"DIFFER (max abs {e})"),
                      flush=True)
    return out


def hold_calls(calls, where: str, err: dict, quiet: bool = False) -> bool:
    """``hold`` on (kernel, label, kind, args) calls; True when all are
    bitwise equal."""
    kept = {}
    for kernel, label, kind, args in calls:
        kept.setdefault(kernel, []).append((label, kind, args))
    return all(r[-1] for r in hold(kept, where, err, quiet))


# ---------------------------------------------------------------- bounds

def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs if x is not None)


def call_work(kernel, args, outs) -> tuple[int, int]:
    """(bytes, f64 operations) one call needs: each input read once and
    each output written once (a compacted cast reads its C lanes' rays);
    the f64 operations of the module docstring."""
    if kernel == "ray_rows":
        O, u, cap, active, _ = args
        R = O.x.shape[0]
        return _nbytes([*O, *u, cap, active]) + _nbytes(outs), 6 * R
    if kernel == "compact_bits":
        keys, C, _, O, u, _, _, (boxes, tiles), cap, active = args
        per_lane = _nbytes([c[:1] for c in (*O, *u)]) + sum(
            x.element_size() for x in (cap, active) if x is not None)
        return (keys[:C].numel() * 4 + C * per_lane
                + _nbytes([boxes[:, :6], tiles]) + _nbytes(outs), 6 * C)
    if kernel == "scatter":
        keys, _, _, ins, _ = args
        return _nbytes([keys, *ins]) + _nbytes(outs), 0
    steps, _, _ = args
    diffuse = sum(int(s[0].sum()) for s in steps)
    return _nbytes([t for s in steps for t in s]) + _nbytes(outs), \
        6 * diffuse


def call_bound(kernel, args, outs) -> tuple[float, str]:
    """(bound_ms, bound_by) of one call: the larger of its bytes over the
    memory rate and its f64 operations over the f64 peak (``call_work``);
    compact_bits' of ``bench/cull.call_bound``, its slab tests too."""
    if kernel == "compact_bits":
        from raytracinggpu_tpu_torch.bench.cull import call_bound as cull_bound

        return cull_bound(kernel, args, outs)[:2]
    nbytes, f64 = call_work(kernel, args, outs)
    bytes_s, ops_s = nbytes / PEAK_BYTES_S, f64 / PEAK_F64_FLOPS
    return max(bytes_s, ops_s) * 1e3, ("operations" if ops_s > bytes_s
                                       else "bytes")


# ------------------------------------------------------------ hard inputs

def hard_rays(R: int, device, seed: int = 0):
    """(O, u, cap, active) of R seeded lanes: NaN, infinite, huge (the
    cross product's f32 products overflow), zero, -0.0 and denormal
    components of origins and directions, NaN and infinite caps, and the
    last R/16 lanes the ray padding's (O = 0, u = 1, cap = 0,
    inactive)."""
    rng = np.random.default_rng(seed)
    O = rng.uniform(-60, 60, (3, R)).astype(np.float32)
    d = rng.normal(size=(3, R))
    u = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    cap = rng.uniform(0, 100, R).astype(np.float32)
    k = rng.integers(0, 10, R)
    c = rng.integers(0, 3, R)
    ar = np.arange(R)
    O[c[k == 0], ar[k == 0]] = np.nan
    O[c[k == 1], ar[k == 1]] = np.inf
    u[c[k == 1], ar[k == 1]] = -np.inf
    O[:, k == 2] *= np.float32(1e30)
    u[:, k == 3] = np.float32(0.0)
    u[1, k == 3] = np.float32(-0.0)
    u[c[k == 4], ar[k == 4]] = np.float32(-0.0)
    u[c[k == 5], ar[k == 5]] = np.float32(1e-40) * np.sign(
        rng.normal(size=int((k == 5).sum()))).astype(np.float32)
    O[c[k == 6], ar[k == 6]] = np.float32(-1e-42)
    u[c[k == 7], ar[k == 7]] = np.nan
    cap[k == 8] = np.nan
    cap[k == 9] = np.inf
    active = rng.random(R) < 0.6
    pad = R - R // 16
    O[:, pad:], u[:, pad:], cap[pad:], active[pad:] = 0.0, 1.0, 0.0, False
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return Vec3(*T(O)), Vec3(*T(u)), T(cap), T(active)


def sorted_keys(R: int, shift: int, device, seed: int = 0):
    """A compacted cast's sorted keys over R lanes: (group << shift) |
    lane, the groups random, then sorted (a permutation of the lanes)."""
    rng = np.random.default_rng(seed)
    groups = rng.integers(0, 1 << min(31 - shift, 12), R).astype(np.int64)
    keys = np.sort((groups << shift) | np.arange(R)).astype(np.int32)
    return torch.from_numpy(keys).to(device)


def culled_rays(R: int, device, seed: int = 0):
    """(O, u, cap, active, members, nc) of R seeded lanes for a compacted
    cast's culling: ``bench/cull.adversarial``'s rays (zero direction
    components, origins on box faces and corners, caps at an exact enter
    distance) against its 1,100 member boxes in 300 tiles (flat, point and
    inverted boxes), with a fifth of the lanes ``hard_rays``' (NaN,
    infinite, huge, denormal and -0.0 components, the padding lanes')."""
    from raytracinggpu_tpu_torch.bench.cull import adversarial

    O, d, boxes, tiles, cap, act = adversarial(seed, R, 1100, 300)
    hO, hu, hcap, hact = hard_rays(R, "cpu", seed)
    hard = np.random.default_rng(seed + 7).random(R) < 0.2
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    pick = lambda h, x: torch.where(T(hard), h, T(x)).to(device)
    return (Vec3(*(pick(h, x) for h, x in zip(hO, O))),
            Vec3(*(pick(h, x) for h, x in zip(hu, d))), pick(hcap, cap),
            pick(hact, act), (T(boxes).to(device), T(tiles).to(device)), 300)


def _bit_patterns(n: int, rng, dtype):
    """n 32-bit words of ``dtype``: random bits (NaNs with payloads,
    infinities, denormals and -0.0 among the floats)."""
    w = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    w[rng.random(n) < 0.05] = 0x80000000  # -0.0
    w[rng.random(n) < 0.05] = 0x7F800000  # inf
    return torch.from_numpy(w.view(np.int32)).view(dtype)


def adversarial_calls(device, R: int = 65536, seed: int = 0) -> list:
    """[(kernel, label, kind, args), ...] on ``device``: the ray rows of
    ``hard_rays`` in every layout and with every set of extras; compacted
    casts' rows and culling (``culled_rays``) at C = 0, a few lanes, a
    third and C = Rp, subgroups 1, 16 and 64; scatters of
    one, two and five outputs of random bits at the same widths, with the
    queries' defaults and with -0.0 and -1; composites of 1, 5, 8, 9 and
    17 depths (past a launch's COMPOSITE_DEPTHS) with is_diff all true,
    none and mixed, and NaN, infinite, denormal and -0.0 albedos and
    direct terms."""
    rng = np.random.default_rng(seed)
    O, u, cap, active = hard_rays(R, device, seed)
    calls = []
    for c, a, layout in ((None, None, "pairs"), (None, None, "live"),
                         (cap, None, "live"), (None, active, "live"),
                         (cap, active, "live"), (cap, active, "pairs"),
                         (None, None, "pallas")):
        label = f"hard rays, cap {c is not None}, active {a is not None}"
        calls.append(("ray_rows", label, layout, (O, u, c, a, layout)))
    shift = (R - 1).bit_length()
    keys = sorted_keys(R, shift, device, seed)
    widths = (0, 7, R // 3, R)
    Oc, uc, capc, actc, members, nc = culled_rays(R, device, seed)
    # subgroups that divide C: one ray a thread at 1, up to four at 16, 64
    for C, subg in ((0, 64), (7, 1), (R // 3, 1), (R // 3 // 16 * 16, 16),
                    (R, 64)):
        for c, a in ((None, None), (capc, None), (capc, actc),
                     (None, actc)):
            calls.append(("compact_bits", f"C {C} of {R}, subgroup {subg}, "
                          f"cap {c is not None}, active {a is not None}",
                          "hard", (keys, C, shift, Oc, uc, nc, subg, members,
                                   c, a)))
    for C in widths:
        for n, dflt in ((1, NO_HIT[:1]), (2, NO_HIT[:2]), (5, NO_HIT),
                        (5, (-0.0, -1, float("inf"), -0.0, 0.0))):
            dts = [torch.float32, torch.int32] + [torch.float32] * 3
            outs = tuple(_bit_patterns(C, rng, dt).to(device)
                         for dt in dts[:n])
            calls.append(("scatter", f"C {C} of {R}, {n} outputs, defaults "
                          f"{dflt}", "hard", (keys, C, shift, outs, dflt)))
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    n = R // 4
    for D in (1, 5, 8, 9, 17):
        for diff in ("all", "none", "mixed"):
            steps = []
            for _ in range(D):
                is_diff = {"all": np.ones(n, bool), "none": np.zeros(n, bool),
                           "mixed": rng.random(n) < 0.7}[diff]
                alb = rng.uniform(0, 1, (3, n)).astype(np.float32)
                direct = rng.uniform(0, 50, (3, n)).astype(np.float32)
                for x in (alb, direct):
                    kk = rng.integers(0, 40, (3, n))
                    x[kk == 0] = np.nan
                    x[kk == 1] = np.inf
                    x[kk == 2] = np.float32(-0.0)
                    x[kk == 3] = np.float32(3e-41)
                    x[kk == 4] = -x[kk == 4]
                steps.append((T(is_diff), T(direct), T(alb)))
            calls.append(("composite", f"{D} depths, is_diff {diff}",
                          "hard", (tuple(steps), n, device)))
    return calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("cast_glue: no CUDA device", file=sys.stderr)
        return 1
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    _kernels.load()
    entry = None
    for line in _kernels.BUILD_INFO["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in ("rows_kernelILb0E", "rows_kernelILb1E",
                                      "scatter_kernel", "composite_kernel")
                          if k in line), None)
        elif entry and ("registers" in line or "spill" in line):
            print(f"  ptxas {entry}: {line.strip()}")
    dev = torch.device("cuda", 0)
    n = args.size
    ok, err = True, {}
    for name, kw in (("array_bvh", dict(pairs_compact_min_depth=0,
                                        pairs_block=1024)),
                     ("array_bvh", dict(traversal="pallas")),
                     ("realtime", {}), ("showcase", {})):
        cfg, tab = build_preset(name, dev, width=n, height=n, spp=4,
                                max_depth=3, **kw)
        where = f"{name} {cfg.traversal} {n}x{n}"
        _kernels.reset_launches()
        kept, (img, st) = capture(lambda: render_preset_frame(tab, cfg, 0))
        launches = {k: _kernels.LAUNCHES[k] for k in _kernels.GLUE}
        ok &= all(r[-1] for r in hold(kept, where, err))
        with plain_glue():
            _kernels.reset_launches()
            img_p, st_p = render_preset_frame(tab, cfg, 0)
            plain_launches = {k: _kernels.LAUNCHES[k] for k in _kernels.GLUE}
        same = np.array_equal(img, img_p) and all(
            np.array_equal(a, b) for a, b in zip(st, st_p))
        ok &= same and not any(plain_launches.values())
        print(f"cast glue {where}: launches {launches}; the frame "
              + ("bitwise" if same else "DIFFERS from")
              + f" the frame with the plain glue (launches "
              f"{plain_launches})", flush=True)
    for seed in (0, 1):
        ok &= hold_calls(adversarial_calls(dev, seed=seed),
                         f"hard lanes seed {seed}", err)
    print(f"cast glue: largest errors {err}")
    print("cast glue: " + ("all bitwise" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
