"""Benchmark sweep harness (port of ``raytracinggpu_tpu/bench/sweep.py``).

The protocol of the reference's benchmark.py: sweep spp x bounces with
repeats and print a matrix of runtimes, plus the steady frame time apart
from the first frame, the derived Mray/s, and a JSON file for regression
tracking.  Frames render on ``device``, the CUDA device by default, timed
on the host clock with every frame ended by ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import json
import time

import numpy as np
import torch


def run_sweep(
    preset: str = "array_bvh",
    width: int = 512,
    height: int = 512,
    spps=(1, 2, 4, 8, 16, 32, 64, 128, 256),
    bounces=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
    repeats: int = 5,
    traversal: str = "dense",
    out: str | None = None,
    on_cell=None,
    skip=None,
    device=None,
) -> dict:
    """Render every (spp, bounces) cell ``repeats`` times; returns {(spp,
    bounces): {"first_s", "steady_s", "mrays"}}.  ``first_s`` is the
    cell's first frame (in the sweep's first cell it holds the kernels'
    build and the allocator's warm-up), ``steady_s`` the mean of the other
    repeats, ``mrays`` the reference ray count over it.  ``skip(spp,
    bounces)`` leaves a cell out, ``on_cell(spp, bounces, result)`` sees
    each as it ends, ``out`` names a JSON file of the results."""
    from raytracinggpu_tpu_torch.api import render_device
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render.pipeline import (
        Camera,
        rays_per_frame,
        render_frame,
    )
    from raytracinggpu_tpu_torch.scene.presets import build_preset

    dev = render_device(device)

    def frame(tables, cfg, cam, seed):
        t0 = time.perf_counter()
        render_frame(tables, cfg, cam, PRNGKey(seed, dev))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    results = {}
    for b in bounces:
        for s in spps:
            if skip is not None and skip(int(s), int(b)):
                continue
            cfg, tables = build_preset(
                preset, dev, width=width, height=height, spp=int(s),
                max_depth=int(b), traversal=traversal)
            cam = Camera.default(cfg, dev)
            first = frame(tables, cfg, cam, 0)
            steady = [frame(tables, cfg, cam, r + 1)
                      for r in range(max(1, repeats - 1))]
            dt = float(np.mean(steady))
            mrays = rays_per_frame(cfg) / dt / 1e6
            results[(s, b)] = {
                "first_s": first,
                "steady_s": dt,
                "mrays": mrays,
            }
            print(f"spp={s:4d} bounces={b:2d}: {dt:.3f}s steady "
                  f"({mrays:8.1f} Mray/s, first {first:.1f}s)", flush=True)
            if on_cell is not None:
                on_cell(int(s), int(b), results[(s, b)])

    # benchmark.py-style matrix (rows=spp, cols=bounces).
    print("\truntime matrix (s): rows=spp, cols=bounces")
    for s in spps:
        row = " ".join(
            f"{results[(s, b)]['steady_s']:.3f}" if (s, b) in results else "-"
            for b in bounces
        )
        print(f"{s:4d}: {row}")

    if out:
        with open(out, "w") as f:
            json.dump(
                {f"{s}x{b}": v for (s, b), v in results.items()}, f, indent=1
            )
        print(f"wrote {out}")
    return results
