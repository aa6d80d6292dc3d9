"""Multi-device rendering over ``torch.distributed`` (port of
``raytracinggpu_tpu/parallel/sharding.py``).

One frame is rendered across a (px, sp) mesh of ranks, rank
``ip * n_sp + isp``:

- px index ``ip`` renders the global rows ``ip * rows_per +
  arange(rows_per)``;
- sp index ``isp`` renders the global sample ids ``isp * spp_per +
  arange(spp_per)``.

The uniforms are keyed per (sample, global row) (``core/rng.row_uniforms``)
and a ray's result does not depend on the other rays of its cast, so every
mesh traces the rays of one device.  The JAX package merges the sp axis
with a ``psum`` of partial sums, which rounds as one device only when the
fusion groups align with the sample shard.  The port adds a pixel's
samples one at a time in global sample order (``render/pipeline.py``), and
a sum of partial sums would round otherwise (an NCCL all-reduce promises no
order at all).  So the sp ranks exchange their samples' colours unsummed,
and each adds all spp of them in sample order from zero
(``pipeline.sum_samples``): the sharded frame is ``render_frame``'s bit for
bit, for every mesh, ``spp_fuse`` and cast size.  A mesh with one sp rank
exchanges no samples: each rank sums its own (``render_rows``).

Every exchange is an ``all_reduce`` SUM over zero-filled disjoint slots,
which gloo takes on CUDA tensors as NCCL does.  Each element has one term
that is not +0, so every order of the sum gives that term.  A -0 term
comes out +0, which cannot change a pixel: the accumulator starts at +0
and is never -0, and x + -0 == x + +0 for every such x.  The TraceStats
are integers, summed over the world exactly.

Backends: NCCL when every rank has a CUDA device of its own; gloo on the
CPU and when ranks share one card (NCCL refuses two ranks on one GPU).
``launch`` picks the backend, prints it, and never retries on another.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from raytracinggpu_tpu_torch.core.device import render_device
from raytracinggpu_tpu_torch.core.rng import Key
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.integrator.wavefront import TraceStats
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    frame_rows,
    render_rows,
    sample_colors,
    sum_samples,
)
from raytracinggpu_tpu_torch.scene.scene import RenderConfig, SceneTables


@dataclass(frozen=True)
class DeviceMesh:
    """A (px, sp) mesh of ranks, as seen by one of them: the mesh's shape,
    this rank's (ip, isp) and device, and its process groups: the ranks
    with its isp (px) and with its ip (sp).  A group is None when its axis
    has one rank."""

    n_px: int
    n_sp: int
    ip: int
    isp: int
    device: torch.device
    px_group: object = None
    sp_group: object = None

    @property
    def rank(self) -> int:
        return self.ip * self.n_sp + self.isp


def world_size() -> int:
    """Ranks in the initialised world; a process with no group is a world
    of one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_px: int | None = None, n_sp: int = 1,
              device=None) -> DeviceMesh:
    """The (px, sp) mesh over the initialised world, this rank on
    ``device`` (the CUDA device by default); every rank on px by default.
    Every rank of the world must call it, with the same shape: it creates
    each axis' groups (``dist.new_group`` is collective)."""
    dev = render_device(device)
    n = world_size()
    if n_px is None:
        n_px = n // n_sp
    if n_px < 1 or n_sp < 1 or n_px * n_sp != n:
        raise ValueError(f"a (px {n_px}, sp {n_sp}) mesh needs "
                         f"{n_px * n_sp} ranks; the world has {n}")
    ip, isp = divmod(dist.get_rank() if n > 1 else 0, n_sp)
    px_group = sp_group = None
    if n_px > 1:
        for j in range(n_sp):
            g = dist.new_group([i * n_sp + j for i in range(n_px)])
            px_group = g if j == isp else px_group
    if n_sp > 1:
        for i in range(n_px):
            g = dist.new_group([i * n_sp + j for j in range(n_sp)])
            sp_group = g if i == ip else sp_group
    return DeviceMesh(n_px, n_sp, ip, isp, dev, px_group, sp_group)


def shard_shape(height: int, spp: int, n_px: int,
                n_sp: int) -> tuple[int, int]:
    """(rows, samples) of one rank.  Raises ValueError unless px divides
    the frame's height and sp its spp, the JAX package's rule."""
    if height % n_px:
        raise ValueError(f"the frame's height {height} is not divisible by "
                         f"px = {n_px}")
    if spp % n_sp:
        raise ValueError(f"spp {spp} is not divisible by sp = {n_sp}")
    return height // n_px, spp // n_sp


def _canonical(dev: torch.device) -> torch.device:
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def render_shard(scene: SceneTables, cfg: RenderConfig, cam: Camera,
                 key: Key, mesh: DeviceMesh):
    """This rank's share of the frame, before any exchange.  With one sp
    rank: its rows' accumulated radiance, (3, rows*W) float32.  Otherwise
    the colours of its samples in their slots of a zero-filled (spp, 3,
    rows*W) buffer.  Also its TraceStats."""
    rows_per, spp_per = shard_shape(cfg.height, cfg.spp, mesh.n_px,
                                    mesh.n_sp)
    if _canonical(torch.device(scene.device)) != _canonical(mesh.device):
        raise ValueError(f"the scene is on {scene.device}, the mesh's rank "
                         f"on {mesh.device}")
    rows = mesh.ip * rows_per + np.arange(rows_per, dtype=np.int32)
    s0 = mesh.isp * spp_per
    samples = range(s0, s0 + spp_per)
    if mesh.n_sp == 1:
        acc, stats = render_rows(scene, cfg, cam, key, rows, samples)
        return torch.stack(tuple(acc)), stats
    cols, stats = sample_colors(scene, cfg, cam, key, rows, samples)
    part = cols.new_zeros((cfg.spp, *cols.shape[1:]))
    part[s0:s0 + spp_per] = cols
    return part, stats


def merge_shards(cfg: RenderConfig, mesh: DeviceMesh, part: torch.Tensor,
                 stats: TraceStats):
    """Exchange ``render_shard``'s results: (the (H, W, 3) float32 frame,
    the world's TraceStats), both on every rank."""
    if mesh.n_sp > 1:
        dist.all_reduce(part, group=mesh.sp_group)  # every sample's colour
        acc = sum_samples(part)
    else:
        acc = Vec3(*part)
    img = frame_rows(cfg, acc)
    if mesh.n_px > 1:
        rows_per = img.shape[0]
        full = img.new_zeros((cfg.height, cfg.width, 3))
        full[mesh.ip * rows_per:(mesh.ip + 1) * rows_per] = img
        dist.all_reduce(full, group=mesh.px_group)
        img = full
    if mesh.n_px * mesh.n_sp > 1:
        counts = torch.stack(tuple(stats))
        dist.all_reduce(counts)
        stats = TraceStats(*counts)
    return img, stats


def render_frame_sharded(scene: SceneTables, cfg: RenderConfig, cam: Camera,
                         key: Key, mesh: DeviceMesh):
    """Render one frame across ``mesh``: (the (H, W, 3) float32 frame on
    every rank, the TraceStats summed over the world), bitwise
    ``render_frame``'s on one device.  Every rank of the mesh calls it.
    Raises ValueError unless px divides the height and sp the spp."""
    part, stats = render_shard(scene, cfg, cam, key, mesh)
    return merge_shards(cfg, mesh, part, stats)


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device=None) -> DeviceMesh:
    """Join a world of ``num_processes`` processes, one a host, through
    ``tcp://coordinator`` (host:port), and build the mesh over it: sp = 2
    when the world is even and larger than one, px the rest.  The backend
    is NCCL for a CUDA ``device``, gloo for the CPU.  One process with no
    group is a world of one: a 1x1 mesh."""
    dev = render_device(device)
    if num_processes is not None and num_processes > 1:
        if coordinator is None or process_id is None:
            raise ValueError(f"a world of {num_processes} processes needs "
                             "the coordinator's host:port and this "
                             "process's id")
        backend = "nccl" if dev.type == "cuda" else "gloo"
        print(f"initialize_multihost: process {process_id} of "
              f"{num_processes} over {backend}", flush=True)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)
    n = world_size()
    n_sp = 2 if n % 2 == 0 and n > 1 else 1
    return make_mesh(n // n_sp, n_sp, dev)


# ---- the local launcher ----------------------------------------------------

def rank_devices(device, n: int) -> list[torch.device]:
    """The devices of n local ranks: ``cuda`` (no index) the first n cards,
    one a rank; a device with an index, or ``cpu``, n times.  Raises
    RuntimeError without a CUDA device and ValueError for more cards than
    the machine has."""
    dev = render_device(device)
    if dev.type == "cuda" and dev.index is None:
        have = torch.cuda.device_count()
        if n > have:
            raise ValueError(f"{n} ranks on one card each need {n} CUDA "
                             f"devices; this machine has {have}")
        return [torch.device("cuda", i) for i in range(n)]
    return [dev] * n


def backend_for(devices) -> str:
    """NCCL when every rank has a CUDA device of its own, else gloo."""
    devs = [_canonical(torch.device(d)) for d in devices]
    if all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs):
        return "nccl"
    return "gloo"


def _rank_main(fn, args, init: str, backend: str, rank: int, n: int,
               device: str, timeout: float) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    if backend == "gloo":
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # local ranks
    # the collectives wait past the launcher's deadline, so that a hung
    # rank is reported as hung, not as its peers' timeout
    dist.init_process_group(backend, init_method=init, world_size=n,
                            rank=rank,
                            timeout=timedelta(seconds=timeout + 60))
    try:
        fn(dev, *args)
    finally:
        dist.destroy_process_group()


def _wait(procs, timeout: float) -> int:
    """0 once every rank has exited with 0; 1 as soon as one exits
    otherwise, or when ``timeout`` seconds pass first."""
    deadline = time.monotonic() + timeout
    while True:
        failed = {r: p.exitcode for r, p in enumerate(procs)
                  if p.exitcode not in (None, 0)}
        if failed:
            print(f"launch: ranks exited with {failed}", file=sys.stderr,
                  flush=True)
            return 1
        running = [p for p in procs if p.exitcode is None]
        if not running:
            return 0
        left = deadline - time.monotonic()
        if left <= 0:
            hung = [r for r, p in enumerate(procs) if p.exitcode is None]
            print(f"launch: ranks {hung} still running after {timeout} s",
                  file=sys.stderr, flush=True)
            return 1
        mp.connection.wait([p.sentinel for p in running], timeout=left)


def launch(fn, devices, *args, timeout: float = 600.0) -> int:
    """Run ``fn(device, *args)`` in one spawned process per entry of
    ``devices``, rank r on ``devices[r]``, in one ``torch.distributed``
    world that meets in a ``file://`` store in a temporary directory.  fn
    must be importable by name (spawn pickles it so).  Returns 0 when every
    rank returned, 1 when a rank failed or ``timeout`` seconds passed
    first; every rank still running then is stopped."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    backend = backend_for(devices)
    print(f"launch: {n} ranks on {', '.join(map(str, devices))} over "
          f"{backend}", flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rt_launch_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, name=f"rank{r}",
                             args=(fn, args, init, backend, r, n, str(d),
                                   timeout))
                 for r, d in enumerate(devices)]
        try:
            for p in procs:
                p.start()
            return _wait(procs, timeout)
        finally:
            started = [p for p in procs if p.pid is not None]
            for p in started:
                if p.exitcode is None:
                    p.terminate()
            for p in started:
                p.join(10)
                if p.exitcode is None:
                    p.kill()
                    p.join()
