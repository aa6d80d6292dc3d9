"""Multi-process demo and the multichip dry run (port of
``raytracinggpu_tpu/parallel/multihost_demo.py`` and of
``__graft_entry__.py``'s ``dryrun_multichip``).

The demo starts a world of local ranks (``sharding.launch``; by default
four, one on each of the first four cards) and renders one frame,
``array_bvh`` 32x32 spp 4 depth 2 through ``dense``, on a (px n/2, sp 2)
mesh (four ranks: 2 x 2) with ``render_frame_sharded``.  Rank 0 holds the gathered frame against a
single-process ``render_frame`` of the same config, bit for bit (the JAX
demo allows a tolerance; the port's sharded frame is bitwise one
device's).

The dry run renders its two legs on an n-rank mesh, (n/2, 2) when n is
even, each held bit for bit against the single-device frame on rank 0:

- ``dense`` 256x256 spp 4 depth 2;
- ``pairs`` 64x64 spp 2 depth 2 on the SAH tree's pave tables, cut 32,
  the compaction ladder's first tier at 0.25 and casts padded to 128 rays
  (the JAX leg's knobs).

    python -m raytracinggpu_tpu_torch.parallel.multihost_demo  # 4 cards
    python -m raytracinggpu_tpu_torch.parallel.multihost_demo \\
        --device cuda:0 --processes 2          # two ranks share one card
    python -m raytracinggpu_tpu_torch.parallel.multihost_demo \\
        --device cpu                           # four CPU ranks on gloo
    python -m raytracinggpu_tpu_torch.parallel.multihost_demo --dryrun 4

Exits nonzero when a rank fails, a check fails or a rank hangs past the
launcher's timeout.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.parallel import sharding
from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
from raytracinggpu_tpu_torch.scene.presets import build_preset

DEMO = dict(width=32, height=32, spp=4, max_depth=2, traversal="dense")

# The JAX leg sets spp_fuse = spp // sp so that its fusion groups align with
# the sample shard; the port's frame is bitwise one device's at any
# spp_fuse, so the legs keep the preset's.
DRYRUN_LEGS = (
    dict(width=256, height=256, spp=4, max_depth=2, traversal="dense"),
    dict(width=64, height=64, spp=2, max_depth=2, traversal="pairs",
         pairs_cluster="sah", pairs_pack="pave", pairs_cut=32,
         pairs_compact=0.25, pairs_block=128),
)


def dryrun_legs(shrink: int = 1) -> list[dict]:
    """The dry run's legs, their width and height divided by ``shrink``."""
    return [dict(leg, width=leg["width"] // shrink,
                 height=leg["height"] // shrink) for leg in DRYRUN_LEGS]


def _check(img, stats, ref, ref_stats, what: str) -> None:
    if not torch.equal(img, ref):
        n = int((img != ref).any(-1).sum())
        raise SystemExit(f"{what}: the sharded frame differs from the "
                         f"single-device frame on {n} pixels")
    if any(not torch.equal(a, b) for a, b in zip(stats, ref_stats)):
        raise SystemExit(f"{what}: the sharded TraceStats differ from the "
                         "single-device ones")


def _mesh(device) -> sharding.DeviceMesh:
    """(n/2, 2) over an even world of n ranks, else (n, 1)."""
    n = sharding.world_size()
    n_sp = 2 if n % 2 == 0 and n > 1 else 1
    return sharding.make_mesh(n // n_sp, n_sp, device)


def worker(device, out_path: str | None) -> None:
    """One rank of the demo's world: render the demo frame sharded; rank 0
    checks it against the single-process frame."""
    mesh = _mesh(device)
    cfg, tables = build_preset("array_bvh", device, **DEMO)
    cam = Camera.default(cfg, device)
    img, stats = sharding.render_frame_sharded(
        tables, cfg, cam, PRNGKey(0, device), mesh)
    if mesh.rank != 0:
        return
    ref, ref_stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
    _check(img, stats, ref, ref_stats, "multihost")
    msg = (f"multihost OK: {mesh.n_px * mesh.n_sp} processes on {device}, "
           f"mesh px={mesh.n_px} sp={mesh.n_sp}, frame "
           f"{cfg.height}x{cfg.width}, gathered == single-process BITWISE")
    print(msg, flush=True)
    if out_path:
        with open(out_path, "w") as f:
            f.write(msg + "\n")


def launch(num_processes: int = 4, device=None, out_path: str | None = None,
           timeout: float = 600.0) -> int:
    """Start the demo's world (``sharding.rank_devices(device,
    num_processes)``: one card a rank by default) and wait; returns 0 on
    success."""
    devices = sharding.rank_devices(device, num_processes)
    return sharding.launch(worker, devices, out_path, timeout=timeout)


def _dryrun_rank(device, shrink: int) -> None:
    mesh = _mesh(device)
    for leg in dryrun_legs(shrink):
        cfg, tables = build_preset("array_bvh", device, **leg)
        cam = Camera.fixed(device, cfg.camera_c)
        t0 = time.perf_counter()
        img, stats = sharding.render_frame_sharded(
            tables, cfg, cam, PRNGKey(0, device), mesh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if mesh.rank != 0:
            continue
        ref, ref_stats = render_frame(tables, cfg, cam, PRNGKey(0, device))
        _check(img, stats, ref, ref_stats,
               f"dryrun_multichip [{leg['traversal']}]")
        print(f"dryrun_multichip OK [{leg['traversal']}]: mesh px="
              f"{mesh.n_px} sp={mesh.n_sp} on {device}, frame "
              f"{cfg.height}x{cfg.width} spp={cfg.spp} d={cfg.max_depth}, "
              f"per-rank shard {(cfg.height // mesh.n_px, cfg.width, 3)}, "
              f"sharded == single-device BITWISE, sharded frame {dt:.1f} s",
              flush=True)


def dryrun_multichip(n_devices: int, device=None, shrink: int = 1,
                     timeout: float = 1800.0) -> int:
    """Render the dry run's legs on ``n_devices`` ranks
    (``sharding.rank_devices(device, n_devices)``: one card a rank by
    default), frames divided by ``shrink``; returns 0 when both equal the
    single-device frames."""
    devices = sharding.rank_devices(device, n_devices)
    return sharding.launch(_dryrun_rank, devices, shrink, timeout=timeout)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m raytracinggpu_tpu_torch.parallel.multihost_demo")
    ap.add_argument("--processes", type=int, default=4,
                    help="ranks: a (n/2, 2) mesh when even, else (n, 1)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (one card a rank, NCCL; the default); cuda:K "
                         "(every rank on card K, gloo); cpu (gloo)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="run dryrun_multichip on N ranks instead")
    args = ap.parse_args(argv)
    try:
        if args.dryrun is not None:
            return dryrun_multichip(args.dryrun, args.device)
        return launch(args.processes, args.device, args.out)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
