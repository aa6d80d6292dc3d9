"""Arithmetic the benchmark keeps as its own, frozen, so that a change to
the program cannot move the yardstick.  Each piece names the file and the
commit it was copied from; none of it imports the program.

- ``card_line``: ``raytracinggpu_tpu_torch/bench/_timing.py`` (a4aff6f);
- ``interval_union`` and ``idle_gaps``: the union of the device
  operations' intervals of ``raytracinggpu_tpu_torch/utils/profiling.py``
  ``device_kernels`` (a4aff6f), taken over a whole window;
- ``TierWait``: the wait wrapper of ``raytracinggpu_tpu_torch/bench/
  ladder.py`` ``TierLog`` (a4aff6f);
- ``slab_enter_exit``: ``raytracinggpu_tpu_torch/ops/pallas_trace.py``
  (a4aff6f), the culling's slab test;
- ``FLOP_PER_MT_TEST`` and ``PEAK_F32_FLOPS``: the Moller-Trumbore
  operation count of ``raytracinggpu_tpu_torch/bench/pairs_design.py``
  (a4aff6f) and the H100's published f32 rate outside the tensor cores;
- ``rays_per_frame``: ``raytracinggpu_tpu_torch/render/pipeline.py``
  (a4aff6f), the reference's ray-count formula.
"""
from __future__ import annotations

import subprocess
import time

import torch

# f32 operations of one Moller-Trumbore test as the repo has always
# counted them, and one H100's published f32 rate (SXM, 700 W, no tensor
# cores): the least time of a mesh query is its tests at that rate
FLOP_PER_MT_TEST = 39
PEAK_F32_FLOPS = 67e12


def rays_per_frame(width: int, height: int, spp: int, max_depth: int) -> int:
    """The reference's ray count of a frame: every depth adds one bounce
    ray and one shadow ray to each primary ray, W*H*spp*(2*depth+1)."""
    return width * height * spp * (2 * max_depth + 1)


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi`` prints
    them: a card set below its full limit runs slower under load."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def interval_union(spans) -> float:
    """Total length of the union of (start, end) intervals, in the spans'
    unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(spans, lo: float, hi: float):
    """The gaps of [lo, hi] that no (start, end) interval covers, as a
    list of (start, end)."""
    gaps, at = [], lo
    for s, e in sorted(spans):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


class TierWait:
    """Wrap the ladder's ``_tier(tiers, count)``, which waits for a cast's
    active count and returns the tier taken (0: full width): each call
    appends (depth, tier, seconds waited) to ``log``; ``depth`` is read
    from the caller's ``here`` dict."""

    def __init__(self, here: dict):
        self.here = here
        self.log = []

    def wrap(self, tier):
        def call(tiers, count):
            t0 = time.perf_counter()
            C = tier(tiers, count)
            self.log.append((self.here.get("depth", -1), int(C),
                             time.perf_counter() - t0))
            return C
        return call


def slab_enter_exit(O, u, aabb):
    """Per-ray slab intervals against every box, (n_boxes, R): O and u are
    (3, R) tensors, aabb (n, >=6) rows [mn.xyz, mx.xyz].  ``1/u`` gives
    +-inf and ``0*inf`` NaN, which ``torch.minimum``/``maximum``
    propagate, so a NaN lane enters no box.  Returns (enter, exit, hit)
    with hit = exit >= enter and exit >= 0."""
    big = 3.4e38
    shape = (aabb.shape[0], O.shape[1])
    enter = torch.full(shape, -big, device=O.device)
    exit_ = torch.full(shape, big, device=O.device)
    for ax in range(3):
        rc = 1.0 / u[ax]
        t0 = (aabb[:, ax, None] - O[ax][None, :]) * rc[None, :]
        t1 = (aabb[:, 3 + ax, None] - O[ax][None, :]) * rc[None, :]
        enter = torch.maximum(enter, torch.minimum(t0, t1))
        exit_ = torch.minimum(exit_, torch.maximum(t0, t1))
    hit = (exit_ >= enter) & (exit_ >= 0.0)
    return enter, exit_, hit
