"""The depth step's kernels (``csrc/wavefront.cu``: ``sphere_hit``,
``shade``, ``bounce`` and ``primary_rays``) against their plain versions:
the calls a frame makes, hard inputs, the frames with the plain stages
patched in, and each kernel's bound.

    python -m raytracinggpu_tpu_torch.bench.depth_step [--size N]

builds the kernels, renders an N x N frame (default 128) of ``array_bvh``
through the pairs and the pallas traversal, of ``realtime`` and of
``showcase`` with each stage's first calls kept, holds every kernel bit
for bit against its plain version on them and on ``adversarial_calls``,
holds each frame bitwise against the frame with the plain stages patched
in, and prints each check; it exits 1 on a difference and without a card.
``chip_smoke.py``'s phase 21 runs the same checks at the main path's size.

The stages and their plain versions (``STAGES``): the sphere passes
(``intersect_spheres`` on the closest rays, ``sphere_shadow`` on the
shadow rays, ``ops/sphere.py``), ``shade`` and ``bounce``
(``integrator/wavefront.py``) and ``primary_rays``
(``render/pipeline.py``).  The integrator looks each up in its module, so
``plain_stages`` patches the plain versions in by name and ``capture``
wraps the dispatchers, both through ``bench/_patch.patched``.

``call_bound`` is a call's least time on the card: every input read and
every output written once at the memory rate, or its operations at the
peak rate of their type (f64 outside the tensor cores; 32-bit integers
for the threefry hashes of ``primary_rays``), whichever is larger.  The
operations a lane are counted by hand from ``csrc/wavefront.cu`` (an f64
multiply-add of core/vec.fma is a multiply and an add; an f64 sqrt, cos
or sin one operation; f32 operations and the f32 divisions are left
out), and a threefry hash's integer operations likewise
(``THREEFRY_OPS``, ``THREEFRY_KEY_OPS``): what depends on the hash's
counter is counted once a hash, what depends only on its key once a key,
and the bits' xor and their float assembly are left out, so the bound is
low, never high.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from raytracinggpu_tpu_torch.bench._patch import module, patched
from raytracinggpu_tpu_torch.core.rays import RayBatch
from raytracinggpu_tpu_torch.core.vec import Vec3

PEAK_BYTES_S = 3.35e12  # NVIDIA H100 SXM data sheet: its HBM3
PEAK_F64_FLOPS = 33.5e12  # the same, f64 outside the tensor cores
# 32-bit integer operations: 64 a clock on each of the 132 SMs (the Hopper
# architecture white paper's SM) at the 1.98 GHz boost clock
PEAK_INT32_OPS = 132 * 64 * 1.98e9
# a threefry2x32 hash's integer operations that depend on its counter: 20
# rounds of an add, a rotate (one funnel shift) and a xor; the second word's
# first key injection and its 5 later ones (key word plus round number, a
# constant of the key: one add each); of the first word's 6 injections only
# the last, the others fold into the next round's add (a three-input add)
THREEFRY_OPS = 20 * 3 + 1 + 5 + 1
# and those that depend only on its key, once a key: the third key word (2
# xors) and the 5 second-word injection constants
THREEFRY_KEY_OPS = 2 + 5
# f64 operations a lane (see the module docstring): a sphere of
# rt_sphere_hit (two dots, the delta's multiply-add, the sqrt), its
# normal, rt_shade, rt_bounce and rt_primary_rays (the Cephes log, the
# Box-Muller sqrt, cos and sin, the raygen's multiply-adds and the norm)
F64_SPHERE, F64_NORMAL, F64_SHADE, F64_BOUNCE = 11, 11, 84, 28
F64_PRIMARY = {False: 30, True: 36}  # the fixed camera, the quirk camera

# kernel -> the wavefront-module dispatchers it serves (the integrator's
# names), and the plain version patched in for each
STAGES = {
    "sphere_hit": (("integrator.wavefront", "intersect_spheres",
                    "ops.sphere", "sphere_hit_plain"),
                   ("integrator.wavefront", "sphere_shadow",
                    "ops.sphere", "sphere_shadow_plain")),
    "shade": (("integrator.wavefront", "shade",
               "integrator.wavefront", "shade_plain"),),
    "bounce": (("integrator.wavefront", "bounce",
                "integrator.wavefront", "bounce_plain"),),
    "primary_rays": (("render.pipeline", "primary_rays",
                      "render.pipeline", "primary_rays_into"),),
}


def plain_stages():
    """A context manager: the plain versions patched in for every stage's
    dispatcher (the parent's torch-op path: no kernel of csrc/wavefront.cu
    launches); put back on exit."""
    return patched({(mod, attr): (lambda _, f=getattr(module(pmod), pattr):
                                  f)
                    for entries in STAGES.values()
                    for mod, attr, pmod, pattr in entries})


def clone(x):
    """A deep copy of the tensors of a call's arguments (tuples, named
    tuples and Vec3s of tensors; anything else as it is)."""
    if torch.is_tensor(x):
        return x.clone()
    if isinstance(x, tuple):
        items = [clone(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def capture(render, n: int = 2):
    """Run render() with each stage's dispatcher wrapped to keep a copy of
    the arguments of its first ``n`` calls (the dispatchers run as always;
    put back afterwards).  Returns ({kernel: [(label, kind, args), ...]},
    render's result); kind is ``closest`` or ``shadow`` for sphere_hit and
    the kernel's name for the others; labels name the call's depth (its
    order in the frame's first trace) or sample."""
    kept = {k: [] for k in STAGES}

    def keeping(kernel, kind, fn, label):
        calls = []

        def call(*a, **k):
            if len(calls) < n:
                calls.append(1)
                x = a + tuple(k.values())
                # shade's scene and config as they are; the counts and the
                # buffers dropped (each hold makes its own)
                args = {"shade": lambda: x[:2] + clone(x[2:5]),
                        "bounce": lambda: clone(x[:5]),
                        "primary_rays": lambda: clone(x[:6])}.get(
                            kernel, lambda: clone(x))()
                kept[kernel].append((label(args, len(calls) - 1), kind,
                                     args))
            return fn(*a, **k)
        return call

    depth = lambda a, i: f"depth {i}"
    wrappers = {}
    for kernel, entries in STAGES.items():
        for mod, attr, _, _ in entries:
            kind = {"intersect_spheres": "closest",
                    "sphere_shadow": "shadow"}.get(attr, kernel)
            label = (lambda a, i: f"sample {a[3]}") \
                if kernel == "primary_rays" else depth
            wrappers[mod, attr] = (lambda fn, kernel=kernel, kind=kind,
                                   label=label: keeping(kernel, kind, fn,
                                                        label))
    with patched(wrappers):
        out = render()
    return kept, out


def _buffers(args):
    """Fresh output buffers of a primary_rays call: O, u, un."""
    cfg, rows_t = args[0], args[4]
    R = rows_t.shape[0] * cfg.width
    new = lambda *s: torch.empty(s, dtype=torch.float32,
                                 device=rows_t.device)
    return Vec3(*new(3, R)), Vec3(*new(3, R)), new(cfg.max_depth, 2, R)


def call(kernel, kind, args, plain: bool, counts=None):
    """One call of the kernel (through its dispatcher, on CUDA tensors) or
    of its plain version on ``args`` (a kept call's; its tensors are read,
    not written); returns its outputs as a flat list of tensors, and for
    shade and bounce the (6,) int64 ``counts`` they add to (zeros when
    None) last."""
    from raytracinggpu_tpu_torch.integrator import wavefront as wf
    from raytracinggpu_tpu_torch.ops import sphere
    from raytracinggpu_tpu_torch.render import pipeline as pl

    if kernel == "sphere_hit":
        fn = {("closest", False): sphere.intersect_spheres,
              ("closest", True): sphere.sphere_hit_plain,
              ("shadow", False): sphere.sphere_shadow,
              ("shadow", True): sphere.sphere_shadow_plain}[kind, plain]
        return flatten(fn(*args))
    if kernel == "primary_rays":
        bufs = _buffers(args)
        (pl.primary_rays_into if plain else pl.primary_rays)(*args, *bufs)
        return flatten(bufs)
    if counts is None:
        dev = args[-1].device if kernel == "bounce" else args[2].u.x.device
        counts = torch.zeros(6, dtype=torch.int64, device=dev)
    fn = {"shade": (wf.shade, wf.shade_plain),
          "bounce": (wf.bounce, wf.bounce_plain)}[kernel][plain]
    return flatten(fn(*args, counts)) + [counts]


def run(kernel, kind, args, plain: bool):
    """``call`` on copies of ``args`` (shade's scene and config as they
    are), with zeroed counts."""
    a = args[:2] + clone(args[2:]) if kernel == "shade" else clone(args)
    return call(kernel, kind, a, plain)


def flatten(x) -> list:
    if x is None:
        return []
    if torch.is_tensor(x):
        return [x]
    return [t for v in x for t in flatten(v)]


def bits(x):
    """The tensor's bits as integers (the sign of a zero counts), every
    NaN of a float tensor as one pattern: a NaN's sign and payload depend
    on which instruction propagated it (torch's f64 add is a DFMA, the
    kernels' a DADD, and the card keeps an operand's payload through
    either), not on what the lane computed."""
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    return x.view({4: torch.int32, 8: torch.int64, 1: torch.uint8,
                   2: torch.int16}[x.element_size()])


def same_bits(a: list, b: list) -> bool:
    """Equal outputs, bit for bit but for NaN payloads (see ``bits``)."""
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def max_abs_err(a: list, b: list) -> float:
    """The largest |kernel - plain| over the outputs: 0 where the bits
    agree (``bits``), inf where one is NaN or infinite and the other not."""
    worst = 0.0
    for x, y in zip(a, b):
        same = bits(x) == bits(y)
        d = (x.double() - y.double()).abs()
        d = torch.where(same, 0.0, torch.nan_to_num(d, nan=float("inf")))
        if d.numel():
            worst = max(worst, float(d.max()))
    return worst


def nan_lanes(xs: list) -> int:
    """Lanes where some float output is NaN."""
    n = 0
    for x in xs:
        if x.is_floating_point() and x.dim():
            m = torch.isnan(x)
            n = max(n, int((m.any(0) if m.dim() == 2 else m).sum()))
    return n


def hold(kept, where: str, err: dict, quiet: bool = False) -> list:
    """Each kept call's kernel against its plain version on the card, bit
    for bit.  Returns [(kernel, label, kind, lanes, equal), ...] and
    raises the largest error of each kernel in ``err`` to its max; prints
    a line a call (``quiet``: none)."""
    out = []
    for kernel, calls in kept.items():
        for label, kind, args in calls:
            got = run(kernel, kind, args, plain=False)
            want = run(kernel, kind, args, plain=True)
            torch.cuda.synchronize()
            ok = same_bits(got, want)
            e = 0.0 if ok else max_abs_err(got, want)
            err[kernel] = max(err.get(kernel, 0.0), e)
            lanes = got[0].shape[-1]
            out.append((kernel, label, kind, lanes, ok))
            if not quiet:
                print(f"depth step {where} {label} {kind}: {kernel} on "
                      f"{lanes} lanes ({nan_lanes(want)} with a NaN), "
                      f"{len(got)} outputs: "
                      + ("bitwise equal" if ok else f"DIFFER (max abs {e})"),
                      flush=True)
    return out


def record_replay(targets):
    """(record, replay): two context managers over the functions
    ``targets``, [(module, attribute)] of this package.  Under ``record``
    each call runs and its result is kept in order; under ``replay`` each
    call returns the kept results in that order without running (the
    calls must come as recorded: the same frame and seed).  Replaying a
    frame's mesh casts, or its traces, leaves the launches outside them."""
    kept = {t: [] for t in targets}

    def record(t, fn):
        def call(*a, **k):
            kept[t].append(fn(*a, **k))
            return kept[t][-1]
        return call

    def replay(t, fn):
        it = iter(list(kept[t]))
        return lambda *a, **k: next(it)

    over = lambda way: lambda: patched(
        {t: (lambda fn, t=t: way(t, fn)) for t in targets})
    return over(record), over(replay)


# the mesh casts of a depth step (the traversal's kernels, culling, ladder
# and feature rows), and the integrator call of a cast
MESH_CASTS = (("integrator.wavefront", "_mesh_closest"),
              ("integrator.wavefront", "_mesh_shadow"))
TRACES = (("render.pipeline", "trace"),)


# ---------------------------------------------------------------- bounds

def _nbytes(xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def call_work(kernel, kind, args, outs) -> tuple[int, dict]:
    """(bytes, {type: operations}) one call needs: each input read once and
    each output written once; its f64 operations and, for primary_rays,
    its 32-bit integer ones (the module docstring)."""
    if kernel == "sphere_hit":
        O, u, tab = args[:3]
        R, S = O.x.shape[0], tab.cx.shape[0]
        ins = [*O, *u, *tab] + flatten(args[3:])
        f64 = R * S * F64_SPHERE + (R * F64_NORMAL if kind == "closest"
                                    else 0)
        ops = {"f64": f64}
    elif kernel == "shade":
        scene, cfg, ray, sph, mesh = args
        R = ray.u.x.shape[0]
        ins = [*flatten(ray), *flatten(sph), *flatten(mesh)]
        ops = {"f64": R * F64_SHADE}
    elif kernel == "bounce":
        sh, t_sph, t_mesh, r1, r2 = args
        R = r1.shape[0]
        ins = [*sh.u2, *sh.N, sh.alb, sh.lum, sh.lv2, sh.is_diff,
               sh.sh_active, t_sph, r1, r2] + flatten(t_mesh)
        ops = {"f64": R * F64_BOUNCE}
    else:
        cfg, _, _, _, rows_t, _ = args
        R = rows_t.shape[0] * cfg.width
        ins = [rows_t]
        nr = rows_t.shape[0]
        # the (D + 1, 2) uniforms of a lane under its row's key; a row's
        # fold_in under the sample's key; the sample's under the frame's
        hashes = R * 2 * (cfg.max_depth + 1) + nr + 1
        keys = nr + 2
        ops = {"f64": R * F64_PRIMARY[bool(cfg.camera_point_quirk)],
               "int32": hashes * THREEFRY_OPS + keys * THREEFRY_KEY_OPS}
    return _nbytes(ins) + _nbytes(outs), ops


def call_bound(kernel, kind, args, outs) -> tuple[float, str]:
    """(bound_ms, bound_by) of one call: the larger of its bytes over the
    memory rate and its operations over the peak rate of their type
    (``call_work``)."""
    nbytes, ops = call_work(kernel, kind, args, outs)
    bytes_s = nbytes / PEAK_BYTES_S
    rate = {"f64": PEAK_F64_FLOPS, "int32": PEAK_INT32_OPS}
    ops_s = max(n / rate[k] for k, n in ops.items())
    return max(bytes_s, ops_s) * 1e3, ("operations" if ops_s > bytes_s
                                       else "bytes")


# ------------------------------------------------------------ hard inputs

def adversarial_calls(scene, cfg, R: int = 16384, seed: int = 0) -> list:
    """[(kernel, label, kind, args), ...] on ``scene``'s device: seeded
    lanes on which the stages are easy to get wrong.  The rays: NaN and
    infinite origin components, huge origins (the dots overflow), zero
    and -0.0 direction components, origins on a sphere's surface (rays
    leaving it, and rays tangent to it), at its centre, inside the
    refractive spheres in their medium at grazing angles (total internal
    reflection), and zero padding lanes.  ``shade`` gets them with the
    mesh's t tied with the sphere's, nearer, INF, NaN or infinite and its
    normal zero, NaN or random (or no mesh, for a scene without one);
    ``bounce`` the shading's outputs with the shadow distances NaN, tied
    with the light's distance, and the uniforms at 1 and at the smallest
    (0, 1] value, the normals with a zero x or y component or zero;
    ``primary_rays`` keys with both words set, samples near 2^32, rows
    past the image, an odd width, depths 0, 1 and 5 and both cameras."""
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.integrator import wavefront as wf
    from raytracinggpu_tpu_torch.ops.sphere import (
        sphere_hit_plain, sphere_shadow_plain)
    from raytracinggpu_tpu_torch.render.pipeline import Camera

    dev = scene.device
    rng = np.random.default_rng(seed)
    tab = scene.spheres
    C = np.stack([c.cpu().numpy() for c in tab[:3]], 1)
    rad = tab.radius.cpu().numpy()
    S = len(rad)
    O = rng.uniform(-30, 30, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    u = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ri = np.ones(R, np.float32)
    mats = scene.materials
    in_ri, out_ri = mats.in_ri.cpu().numpy(), mats.out_ri.cpu().numpy()
    k = rng.integers(0, 12, R)
    s = rng.integers(0, S, R)
    n = rng.normal(size=(R, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    t = np.cross(n, rng.normal(size=(R, 3)))
    t = (t / np.linalg.norm(t, axis=1, keepdims=True)).astype(np.float32)
    surf = (C[s] + rad[s, None] * n).astype(np.float32)
    O[k == 0, rng.integers(0, 3)] = np.nan
    O[k == 1, 0] = np.inf
    O[k == 1, 2] = -np.inf
    O[k == 2] *= np.float32(1e30)
    u[k == 3] = np.float32(0.0)
    u[k == 3, 1] = np.float32(-0.0)
    u[k == 4, rng.integers(0, 3)] = np.float32(-0.0)
    O[k == 5] = surf[k == 5]
    O[k == 6] = surf[k == 6] + np.float32(3.0) * t[k == 6]
    u[k == 6] = -t[k == 6]
    O[k == 7] = C[s[k == 7]]
    refr = np.flatnonzero(in_ri[:S] != out_ri[:S])
    if len(refr):  # inside a refractive sphere, in its medium
        g = refr[rng.integers(0, len(refr), R)]
        inside = (C[g] + np.float32(0.95) * rad[g, None] * n).astype(
            np.float32)
        O[k == 8] = inside[k == 8]
        u[k == 8] = t[k == 8]
        ri[k == 8] = in_ri[g[k == 8]]
        ri[k == 9] = out_ri[g[k == 9]]
    pad = R - R // 16
    O[pad:], u[pad:] = 0.0, 0.0
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    Ov, uv = Vec3(*T(O.T)), Vec3(*T(u.T))
    calls = [("sphere_hit", "adversarial rays", "closest", (Ov, uv, tab))]
    sph = sphere_hit_plain(Ov, uv, tab)
    t_s = sph[0]
    active = T(rng.random(R) < 0.7)
    lv2 = T(rng.uniform(0, 3000, R).astype(np.float32))
    lv2 = torch.where(T(rng.random(R) < 0.3), t_s * t_s, lv2)
    calls.append(("sphere_hit", "adversarial rays", "shadow",
                  (Ov, uv, tab, active, lv2)))
    calls.append(("sphere_hit", "adversarial rays, no active", "shadow",
                  (Ov, uv, tab, None, None)))
    mesh = None
    if scene.mesh is not None:
        tm = T(rng.uniform(0, 80, R).astype(np.float32))
        km = T(rng.integers(0, 6, R))
        tm = torch.where(km == 0, t_s, tm)
        tm = torch.where(km == 1, torch.full_like(tm, 1e9), tm)
        tm = torch.where(km == 2, torch.full_like(tm, float("nan")), tm)
        tm = torch.where(km == 3, torch.full_like(tm, float("inf")), tm)
        Nm = rng.normal(size=(3, R)).astype(np.float32)
        Nm[:, rng.random(R) < 0.05] = 0.0
        Nm[:, rng.random(R) < 0.02] = np.nan
        mesh = (tm, Vec3(*T(Nm)))
    ray = RayBatch(Ov, uv, T(ri))
    calls.append(("shade", "adversarial rays", "shade",
                  (scene, cfg, ray, sph, mesh)))
    counts = torch.zeros(6, dtype=torch.int64, device=dev)
    sh = wf.shade_plain(scene, cfg, ray, sph, mesh, counts)
    t_sph = sphere_shadow_plain(sh.S, sh.d, tab)[0]
    kb = T(rng.integers(0, 8, R))
    t_sph = torch.where(kb == 0, torch.full_like(t_sph, float("nan")), t_sph)
    t_mesh = T(rng.uniform(0, 60, R).astype(np.float32))
    t_mesh = torch.where(kb == 1, torch.full_like(t_mesh, float("nan")),
                         t_mesh)
    t_mesh = torch.where(kb == 2, t_sph, t_mesh)
    t_sh = torch.minimum(t_sph, t_mesh)
    lv2 = torch.where(kb == 3, t_sh * t_sh, sh.lv2)
    r = (1.0 - rng.random((2, R))).astype(np.float32)
    r[:, rng.random(R) < 0.05] = 1.0
    r[:, rng.random(R) < 0.05] = np.float32(2.0**-24)
    N = np.stack([c.cpu().numpy() for c in sh.N])
    N[0, rng.random(R) < 0.05] = 0.0
    N[1, rng.random(R) < 0.05] = 0.0
    N[:, rng.random(R) < 0.02] = 0.0
    sh = sh._replace(lv2=lv2, N=Vec3(*T(N)),
                     is_diff=sh.is_diff | T(rng.random(R) < 0.3))
    r1, r2 = T(r[0]), T(r[1])
    calls.append(("bounce", "adversarial lanes", "bounce",
                  (sh, t_sph, t_mesh, r1, r2)))
    calls.append(("bounce", "adversarial lanes, no mesh", "bounce",
                  (sh, t_sph, None, r1, r2)))
    for quirk, D, seed_k, sample, rows in (
            (False, 5, 2**63 + 2**33 + 7, 2**32 - 1, (0, 1, 22, 100000)),
            (True, 1, 2**40 + 3, 2**31 + 5, (3, 22, 7)),
            (False, 0, 12345, 0, (0, 5))):
        c = dataclasses.replace(cfg, width=37, height=23, max_depth=D,
                                camera_point_quirk=quirk)
        cam = (Camera.from_yaw_pitch((1.0, -2.0, 53.0), 0.37, -0.2, dev)
               if quirk else Camera.default(c, dev))
        rows = np.asarray(rows, np.int64)
        calls.append(("primary_rays", f"width 37, depth {D}, quirk {quirk}",
                      "primary_rays",
                      (c, cam, PRNGKey(seed_k, dev), sample,
                       T(rows), rows)))
    return calls


def sphere_edge_calls(tab, R: int = 65536, seed: int = 0) -> list:
    """[("sphere_hit", label, kind, args), ...] on ``tab``'s device: seeded
    lanes at the edges of rt_sphere_hit's fast loop (csrc/wavefront.cu).
    Ray components at 2^-40 and one f32 under it, at the largest f32
    under 2^30 and at 2^30 (the bounds of its ``moderate``); origins a few
    2^-33 from the origin; rays leaving a sphere of radius 2^-35 at the
    origin from its surface, where e = |O - C|^2 - r^2 is 0 and b * b is
    0, an f32 subnormal (delta under 2^-126: the exact path) or a normal;
    zero directions, origins at the centres.  Over three tables: ``tab``
    with that tiny sphere; the same with a sphere of radius 2^-100 (no
    table check passes: every lane exact); and 100 spheres (two chunks of
    the kernel's shared table).  The closest mode, the shadow mode with
    the pairs cast's active lanes and lv2 (some lv2 = t * t), and without."""
    from raytracinggpu_tpu_torch.ops.sphere import (SphereTable,
                                                    sphere_hit_plain)

    dev = tab.radius.device
    rng = np.random.default_rng(seed)
    f32 = np.float32
    C0 = np.stack([c.cpu().numpy() for c in tab[:3]], 1)
    r0 = tab.radius.cpu().numpy()
    tiny = f32(2.0**-35)
    O = rng.uniform(-40, 40, (R, 3)).astype(f32)
    d = rng.normal(size=(R, 3))
    u = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f32)
    k = rng.integers(0, 10, R)
    col = rng.integers(0, 3, R)
    sign = np.where(rng.random(R) < 0.5, f32(-1), f32(1))
    at = lambda m: (np.flatnonzero(m), col[m])
    i, c = at(k == 1)
    u[i, c] = f32(2.0**-40) * sign[i]
    i, c = at(k == 2)
    u[i, c] = np.nextafter(f32(2.0**-40), f32(0)) * sign[i]
    i, c = at(k == 3)
    O[i, c] = np.nextafter(f32(2.0**30), f32(0)) * sign[i]
    i, c = at(k == 4)
    O[i, c] = f32(2.0**30) * sign[i]
    O[k == 5] = (rng.uniform(-4, 4, (int((k == 5).sum()), 3))
                 * 2.0**-33).astype(f32)
    # on the tiny sphere's surface, leaving it at a slant eps: b = eps * r
    m = np.flatnonzero(k == 6)
    eps = np.array([0.0, 2.0**-40, 2.0**-30, 2.0**-20], f32)[
        rng.integers(0, 4, len(m))]
    O[m] = 0.0
    O[m, col[m]] = tiny * sign[m]
    u[m] = 0.0
    u[m, col[m]] = eps * sign[m]
    u[m, (col[m] + 1) % 3] = 1.0
    u[k == 7] = 0.0
    s = rng.integers(0, len(r0), R)
    O[k == 8] = C0[s[k == 8]]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    Ov, uv = Vec3(*T(O.T)), Vec3(*T(u.T))
    extra = rng.uniform(-50, 50, (100 - len(r0) - 1, 3)).astype(f32)
    tables = {
        "with a tiny sphere": (np.vstack([C0, [[0, 0, 0]]]),
                               np.append(r0, tiny)),
        "with a sphere of radius 2^-100": (
            np.vstack([C0, [[0, 0, 0]], [[1, 2, 3]]]),
            np.append(r0, [tiny, f32(2.0**-100)])),
        "of 100 spheres": (np.vstack([C0, [[0, 0, 0]], extra]),
                           np.concatenate([r0, [tiny], rng.uniform(
                               0.5, 5, len(extra))]))}
    calls = []
    for name, (cen, rad) in tables.items():
        cen, rad = cen.astype(f32), rad.astype(f32)
        st = SphereTable(*(T(cen[:, j]) for j in range(3)), T(rad))
        active = T(rng.random(R) < 0.7)
        lv2 = T(rng.uniform(0, 3000, R).astype(f32))
        t = sphere_hit_plain(Ov, uv, st)[0]
        lv2 = torch.where(T(rng.random(R) < 0.3), t * t, lv2)
        label = f"edge lanes, a table {name}"
        calls += [("sphere_hit", label, "closest", (Ov, uv, st)),
                  ("sphere_hit", label, "shadow", (Ov, uv, st, active, lv2)),
                  ("sphere_hit", f"{label}, no active", "shadow",
                   (Ov, uv, st, None, None))]
    return calls


def hold_calls(calls, where: str, err: dict) -> bool:
    """``hold`` on (kernel, label, kind, args) calls; True when all are
    bitwise equal."""
    kept = {}
    for kernel, label, kind, args in calls:
        kept.setdefault(kernel, []).append((label, kind, args))
    return all(r[-1] for r in hold(kept, where, err))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=128)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("depth_step: no CUDA device", file=sys.stderr)
        return 1
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    _kernels.load()
    entry = None
    for line in _kernels.BUILD_INFO["ptxas"].splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in ("sphere_kernel", "shade_kernel",
                                      "bounce_kernel", "primary_kernel")
                          if k in line), None)
        elif entry and ("registers" in line or "spill" in line):
            print(f"  ptxas {entry}: {line.strip()}")
    dev = torch.device("cuda", 0)
    n = args.size
    ok, err = True, {}
    for name, kw in (("array_bvh", {}), ("array_bvh", dict(traversal="pallas")),
                     ("realtime", {}), ("showcase", {})):
        cfg, tab = build_preset(name, dev, width=n, height=n, spp=4,
                                max_depth=3, **kw)
        where = f"{name} {cfg.traversal} {n}x{n}"
        _kernels.reset_launches()
        kept, (img, st) = capture(lambda: render_preset_frame(tab, cfg, 0))
        launches = {k: _kernels.LAUNCHES[k] for k in _kernels.DEPTH_STEP}
        ok &= all(r[-1] for r in hold(kept, where, err))
        with plain_stages():
            _kernels.reset_launches()
            img_p, st_p = render_preset_frame(tab, cfg, 0)
            plain_launches = {k: _kernels.LAUNCHES[k]
                              for k in _kernels.DEPTH_STEP}
        same = np.array_equal(img, img_p) and all(
            np.array_equal(a, b) for a, b in zip(st, st_p))
        ok &= same and not any(plain_launches.values())
        print(f"depth step {where}: launches {launches}; the frame "
              + ("bitwise" if same else "DIFFERS from")
              + f" the frame with the plain stages (launches "
              f"{plain_launches}); hit {st.hit.tolist()}, tir "
              f"{st.tir.tolist()}", flush=True)
        ok &= hold_calls(adversarial_calls(tab, cfg), where, err)
    print(f"depth step: largest errors {err}")
    print("depth step: " + ("all bitwise" if ok else "FAILED"))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
