"""A large custom mesh through the public entry point (port of
``raytracinggpu_tpu/bench/big_mesh.py``).

Renders a deterministic 200,000-triangle random soup through
``Renderer(obj_path=...)``, the path a user's ``--obj`` takes, with the
LBVH builder, in the ``pairs`` traversal and in its ``pallas`` fallback,
on the CUDA device.  The soup packs into 2,053 pairs tiles (262,784 field
slots, where the JAX package's TPU kernel streams its field table in
32,768-slot supertiles: B4) and 1,564 tiled-traversal tiles.

    python -m raytracinggpu_tpu_torch.bench.big_mesh [--tris N] [--out FILE]

Prints one row per traversal (host build seconds, the best of three
warm frames, Mray/s by the reference ray-count formula), then the run's
outermost spans of the program's tracer (``utils/profiling.py``: the
soup write, each host build, each frame) with their seconds, and, with
``--out``, writes the rows as JSON.
Frames are timed on the host clock, ended by
``torch.cuda.synchronize()``.  Without a CUDA device it exits nonzero.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from raytracinggpu_tpu_torch.scene.mesh import rescale
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
from raytracinggpu_tpu_torch.scene.presets import _MESH_TRANSFORM


def soup_obj(path: str, n_tris: int, seed: int = 7) -> None:
    """Write a deterministic triangle-soup OBJ inside the region the
    array_bvh preset's camera views (the cat mesh's world-space box,
    inflated 1.5x), so every cast pays the full pair arithmetic.  The text
    is the JAX package's soup_obj's, byte for byte."""
    embed, s, off = _MESH_TRANSFORM["array_bvh"]
    obj = read_obj(CAT_OBJ_PATH, embed_transform=embed)
    if s is not None:
        obj.vertices = rescale(obj.vertices, s, off)
    lo = obj.vertices.min(axis=0)
    hi = obj.vertices.max(axis=0)
    c, half = (lo + hi) / 2, (hi - lo) / 2 * 1.5

    rng = np.random.default_rng(seed)
    A = (c + rng.uniform(-1, 1, (n_tris, 3)) * half).astype(np.float32)
    edge = float(half.min()) * 0.02
    B = A + rng.standard_normal((n_tris, 3)).astype(np.float32) * edge
    C = A + rng.standard_normal((n_tris, 3)).astype(np.float32) * edge
    with open(path, "w") as f:
        for tri in range(n_tris):
            for P in (A[tri], B[tri], C[tri]):
                f.write(f"v {P[0]:.6f} {P[1]:.6f} {P[2]:.6f}\n")
            k = 3 * tri
            f.write(f"f {k + 1} {k + 2} {k + 3}\n")


def run(n_tris: int = 200_000, out: str | None = None, width: int = 512,
        height: int = 512, spp: int = 4, max_depth: int = 2) -> dict:
    """Build and render the soup in both traversals on the CUDA device;
    returns the rows (and writes them to ``out`` as JSON when given)."""
    from raytracinggpu_tpu_torch.api import Renderer
    from raytracinggpu_tpu_torch.render.pipeline import rays_per_frame
    from raytracinggpu_tpu_torch.utils import profiling

    card = torch.cuda.get_device_name(0)
    rows = {
        "_": (f"{n_tris}-triangle random soup via the public Renderer "
              f"obj_path API, {width}x{height} spp={spp} depth={max_depth}, "
              f"one {card}; pairs = B1/B2 over the whole field table, "
              "pallas = the tiled fallback (lbvh builder for both)"),
    }
    with tempfile.TemporaryDirectory() as d, profiling.tracing():
        path = os.path.join(d, f"soup_{n_tris}.obj")
        with profiling.span("soup write"):
            soup_obj(path, n_tris)
        for traversal in ("pairs", "pallas"):
            t0 = time.perf_counter()
            r = Renderer("array_bvh", obj_path=path, bvh_builder="lbvh",
                         width=width, height=height, spp=spp,
                         max_depth=max_depth, traversal=traversal)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            if traversal == "pairs":
                tab = r.scene.pairs_mesh
                if tab is None:
                    raise RuntimeError("the soup fell back off the pairs "
                                       "tables")
                rows["pairs_tiles"] = int(tab.tile_aabb.shape[0])
                rows["pairs_field_cols"] = int(tab.fields.shape[1])
            r.render_hdr(seed=0)  # builds the kernels, fills the allocator
            times = []
            for i in range(1, 4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render_hdr(seed=i)  # returns host numpy: synchronous
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            dt = min(times)
            rows[traversal] = {
                "steady_s": dt,
                "mrays_formula": rays_per_frame(r.cfg) / dt / 1e6,
                "host_build_s": build_s,
            }
            print(traversal, rows[traversal], flush=True)
    print(" | ".join(f"{s.name} {(s.end_ns - s.start_ns) * 1e-9:.3f} s"
                     for s in profiling.collect().spans if s.parent < 0),
          flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1)
        print("wrote", out)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--tris", type=int, default=200_000)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("big_mesh: no CUDA device", file=sys.stderr)
        sys.exit(1)
    run(a.tris, a.out)
