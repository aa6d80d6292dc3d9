"""Drive the PyTorch + CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, in order; any failed check exits nonzero:

1. environment: the card's name and power limit (nvidia-smi), torch,
   CUDA and nvcc versions;
2. build: compile the hand-written kernels (csrc/pairs_trace.cu) with
   nvcc for sm_90a and load them;
3. per-cast check: render the main-path frame (array_bvh, 512x512,
   spp 32, depth 5) once while keeping the inputs the frame gives each
   kernel at depths 0 and 1 of its first cast (4 samples fused, 524,288
   rays); on those inputs the kernels must equal their plain PyTorch
   versions bit for bit;
4. headline frame: render the main-path frame through the public entry
   points with the launch counters zeroed just before; the image must be
   finite and equal the phase-3 frame (same seed), every ray must hit the enclosed scene at every depth, some
   shadow rays must be occluded, and each kernel must have launched once
   per cast; then time three frames and print Mray/s;
5. timings: each kernel against its plain version on the casts kept in
   phase 3;
6. production anchor: the 512x512 spp 8 depth 3 seed 0 frame's mean must
   lie within 1% of the JAX package's CPU render of the same frame; the
   JAX package's TPU record is printed beside it (see ANCHOR_* below).

The next-to-last line is a JSON object with one entry per kernel; the
last line is the JSON result.  Without a CUDA device the script exits
nonzero at once and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

# Production anchor, 512x512 spp 8 depth 3 seed 0, array_bvh.  The JAX
# package's record (gallery/oracle_production_r05.jsonl, traversal "bvh")
# was rendered on a TPU, whose f32 rounding self-shadows more wall points
# (gallery/midres_platform_delta.json: array_bvh -3.5% against the CPU
# golden).  The check holds the port to the JAX package's CPU render of the
# same frame (render_rows in 32-row bands, traversal "pairs", mean of the
# f32 image in f64; PERF.md, "Production anchor", gives the command that
# prints it), and prints the TPU record beside it.
ANCHOR_TPU_MEAN = 102257.789
ANCHOR_CPU_MEAN = 104758.80389216123
ANCHOR_RTOL = 0.01


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        _fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Mean device time of fn over iters launches (CUDA events), after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _max_abs_err(a, b) -> float:
    import torch

    if torch.equal(a, b):
        return 0.0
    d = (a.double() - b.double()).abs()
    return float(torch.nan_to_num(d, nan=math.inf).max())


def _capture_casts(render, per_kernel: int):
    """Run render() with each kernel's launch wrapper wrapped so that the
    inputs of its first ``per_kernel`` launches are kept.  The wrapped
    function is the real wrapper, which launches and counts as always; the
    originals are put back afterwards.  Returns ({kernel: [(rfT, bits),
    ...]} in launch order, render's result)."""
    from raytracinggpu_tpu_torch.ops import _kernels

    kept = {k: [] for k in _kernels.LAUNCHES}
    orig = {k: getattr(_kernels, k) for k in kept}

    def keeping(k):
        def launch(rfT, fields, bits, *rest):
            if len(kept[k]) < per_kernel:
                kept[k].append((rfT.clone(), bits.clone()))
            return orig[k](rfT, fields, bits, *rest)
        return launch

    for k in kept:
        setattr(_kernels, k, keeping(k))
    try:
        out = render()
    finally:
        for k, f in orig.items():
            setattr(_kernels, k, f)
    return kept, out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from raytracinggpu_tpu_torch.ops import _kernels
    from raytracinggpu_tpu_torch.ops import pairs_trace as pt
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera, chunk_size, group_size, rays_per_frame, render_frame)
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()

    # ---- 1. environment --------------------------------------------------
    card = _card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, torch CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {count}")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.load()
    info = _kernels.BUILD_INFO
    build_s = time.perf_counter() - t0
    print(f"nvcc: {info['nvcc']} ({info['nvcc_version']})")
    print(f"build: {'compiled' if info['compiled'] else 'cached'} "
          f"{os.path.relpath(info['library'])} in {info['seconds']:.2f} s "
          f"(build+load {build_s:.2f} s)")
    entry = "?"
    for line in info["ptxas"].splitlines():
        if "Compiling entry function" in line:
            # the template argument tells the two specializations apart
            entry = ("pairs_closest" if "ILb1E" in line else
                     "pairs_shadow" if "ILb0E" in line else "?")
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {entry}: {line.strip()}")

    # ---- 3. per-cast check -----------------------------------------------
    t0 = time.perf_counter()
    cfg, tables = build_preset("array_bvh", device, width=512, height=512,
                               spp=32, max_depth=5)
    torch.cuda.synchronize()
    print(f"scene: array_bvh {cfg.width}x{cfg.height} spp {cfg.spp} depth "
          f"{cfg.max_depth}, {tables.pairs_mesh.tile_aabb.shape[0]} tiles, "
          f"subgroup {cfg.pairs_subgroup}, built in "
          f"{time.perf_counter() - t0:.2f} s")
    tab = tables.pairs_mesh
    tw = pt.tile_width(tab)
    subg = cfg.pairs_subgroup
    cam = Camera.default(cfg, device)
    g = group_size(cfg, cfg.spp)
    R_group = g * cfg.width * cfg.height
    chunk = chunk_size(cfg, R_group)
    n_casts = (cfg.spp // g) * cfg.max_depth * -(-R_group // chunk)
    # The integrator launches each kernel once per depth, so the first two
    # launches of each are the depth-0 and depth-1 casts of the frame's
    # first wavefront (samples 0..g-1) and its first chunk of `chunk` rays.
    t0 = time.perf_counter()
    kept, (cap_img, _) = _capture_casts(
        lambda: render_frame(tables, cfg, cam, PRNGKey(0, device)), 2)
    torch.cuda.synchronize()
    print(f"capture frame: {time.perf_counter() - t0:.3f} s; casts of "
          f"{chunk} rays ({g} samples per wavefront)")
    err = {"pairs_closest": 0.0, "pairs_shadow": 0.0}
    casts = {}
    for kname, plain in (("pairs_closest", pt.pairs_closest_plain),
                         ("pairs_shadow", pt.pairs_shadow_plain)):
        if len(kept[kname]) != 2:
            _fail(f"{kname}: captured {len(kept[kname])} casts, expected 2")
        for depth, (rfT, bits) in enumerate(kept[kname]):
            name = f"depth{depth}_{kname.split('_')[1]}"
            casts[name] = (rfT, bits)
            args = (rfT, tab.fields, bits, cfg.eps_leaf, subg, tw)
            got = getattr(_kernels, kname)(*args)
            want = plain(*args)
            if kname == "pairs_shadow":
                got, want = (got,), (want,)
            torch.cuda.synchronize()
            e = max(_max_abs_err(a, b) for a, b in zip(got, want))
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            hits = int((want[0] < pt.INF32).sum())
            pairs = int(sum(bin(int(w) & 0xFFFFFFFF).count("1")
                            for w in bits.flatten().tolist()))
            print(f"cast {name}: rfT {tuple(rfT.shape)}, bits "
                  f"{tuple(bits.shape)}, {hits} mesh hits, {pairs} "
                  f"(subgroup, tile) pairs, {kname} vs plain "
                  f"{'bitwise equal' if same else f'DIFFER (max abs {e})'}")
            if not same:
                _fail(f"{kname} differs from its plain version on {name}")
            err[kname] = max(err[kname], e)

    # ---- 4. headline frame -----------------------------------------------
    _kernels.reset_launches()
    t0 = time.perf_counter()
    img, stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(_kernels.LAUNCHES)
    n_rays = cfg.width * cfg.height * cfg.spp
    hit = stats.hit.tolist()
    print(f"headline frame: {counted_s:.3f} s, launches {launches} "
          f"(expected {n_casts} each), hit per depth {hit}, shadowed "
          f"{stats.shadowed.tolist()}, image mean {float(img.mean()):.3f}")
    if not bool(torch.isfinite(img).all()):
        _fail("headline image has non-finite values")
    if not torch.equal(img, cap_img):
        _fail("the same seed gave another frame than the capture frame")
    if any(h != n_rays for h in hit):
        _fail(f"rays escaped the enclosed scene: hit {hit} != {n_rays}")
    if int(stats.shadowed.sum()) <= 0:
        _fail("no shadow ray was occluded")
    for k, n in launches.items():
        if n != n_casts:
            _fail(f"{k} launched {n} times in the frame, expected {n_casts}")
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(i + 1, device))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    mrays = rays_per_frame(cfg) / min(times) / 1e6
    print(f"headline: {mrays:.3f} Mray/s (array_bvh 512x512 spp32 d5 pairs, "
          f"{rays_per_frame(cfg)} rays/frame, frame times "
          f"{[round(t, 4) for t in times]} s) on {card}")

    # ---- 5. kernel timings -----------------------------------------------
    # every captured cast is timed; the JSON line reports the depth-1 ones
    timing = {}
    for cname, (rfT, bits) in casts.items():
        kname = "pairs_" + cname.split("_")[1]
        kern = getattr(_kernels, kname)
        plain = getattr(pt, f"{kname}_plain")
        args = (rfT, tab.fields, bits, cfg.eps_leaf, subg, tw)
        ms = _time_ms(lambda: kern(*args), 20)
        plain_ms = _time_ms(lambda: plain(*args), 3)
        if cname.startswith("depth1"):
            timing[kname] = (ms, plain_ms)
        print(f"timing {kname} on the {cname} cast ({rfT.shape[1]} rays): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms on {card}")

    # ---- 6. production anchor --------------------------------------------
    import dataclasses

    acfg = dataclasses.replace(cfg, spp=8, max_depth=3)
    img, _ = render_frame(tables, acfg, cam, PRNGKey(0, device))
    mean = float(img.double().mean())
    rel = (mean - ANCHOR_CPU_MEAN) / ANCHOR_CPU_MEAN
    print(f"anchor: 512x512 spp8 d3 seed 0 image mean {mean:.3f} vs the JAX "
          f"package on CPU {ANCHOR_CPU_MEAN:.3f} (rel {rel:+.6f}, limit "
          f"{ANCHOR_RTOL}); its TPU record {ANCHOR_TPU_MEAN} (rel "
          f"{(mean - ANCHOR_TPU_MEAN) / ANCHOR_TPU_MEAN:+.5f})")
    if not abs(rel) <= ANCHOR_RTOL:
        _fail(f"anchor mean {mean} off by {rel:.4%}")

    src = "raytracinggpu_tpu_torch/csrc/pairs_trace.cu"
    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": src,
         "replaces": "raytracinggpu_tpu/ops/pairs_trace.py:513",
         "launches": launches[k], "max_abs_err": err[k],
         "ms": timing[k][0], "plain_ms": timing[k][1]}
        for k in ("pairs_closest", "pairs_shadow")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
