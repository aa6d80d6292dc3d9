"""Command-line frontend (port of ``raytracinggpu_tpu/cli/main.py``, the
``render`` subcommand).

    python -m raytracinggpu_tpu_torch.cli render --preset array_bvh 32 5 \
        --out img.png
    python -m raytracinggpu_tpu_torch.cli render 4 2 --obj mesh.obj \
        --bvh-builder lbvh --selfcheck
    python -m raytracinggpu_tpu_torch.cli render 2 2 --device cpu

The frame renders on ``--device``, the CUDA device by default; without
one the command exits with an error unless ``--device cpu`` is given.  A
flag of the JAX CLI whose mode the port does not have exits with a
message naming its ROADMAP item; none is ignored.  The ``realtime`` and
``bench`` subcommands are not ported yet (ROADMAP A12).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from raytracinggpu_tpu_torch.api import Renderer, render_device
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.render.image_io import tonemap, write_png
from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
from raytracinggpu_tpu_torch.scene.presets import PORTED_PRESETS, PRESET_NAMES
from raytracinggpu_tpu_torch.utils.profiling import device_trace, ray_report

# flags of the JAX CLI for modes the port does not have: (attribute, the
# value that asks for nothing, why it is refused)
_UNPORTED_FLAGS = (
    ("clustering", ("ref", None), "--clustering sah/pave: the SAH cluster "
     "tree and pave packing are not ported yet (ROADMAP A10b)"),
    ("compact", (None,), "--compact: the compaction ladder is not ported "
     "(ROADMAP A5; exact by construction, tuned for the TPU)"),
    ("compact2", (None,), "--compact2: the compaction ladder is not ported "
     "(ROADMAP A5)"),
    ("compact3", (None,), "--compact3: the compaction ladder is not ported "
     "(ROADMAP A5)"),
    ("precision", (None,), "--precision: the port's dense oracle runs in "
     "full f32 only (ROADMAP, Not to port: mxu_precision)"),
    ("spp_unroll", (None,), "--spp-unroll: an XLA scan knob (ROADMAP, Not "
     "to port)"),
    ("chunk_unroll", (None,), "--chunk-unroll: an XLA scan knob (ROADMAP, "
     "Not to port)"),
    ("depth_unroll", (None,), "--depth-unroll: an XLA scan workaround "
     "(ROADMAP, Not to port)"),
)


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("spp", nargs="?", type=int, default=None,
                   help="samples per pixel (reference <num_rays>)")
    p.add_argument("bounces", nargs="?", type=int, default=None,
                   help="max ray depth (reference <num_bounces>)")
    p.add_argument("--preset", default="array_bvh", choices=PRESET_NAMES)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", dest="spp_flag", type=int, default=None)
    p.add_argument("--bounces", dest="bounces_flag", type=int, default=None)
    p.add_argument("--traversal", default=None,
                   choices=["pairs", "pallas", "dense", "bvh"],
                   help="mesh intersection mode (pairs = production kernels)")
    p.add_argument("--precision", default=None, choices=["highest", "default"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=1,
                   help="shard across N devices (only 1 is ported)")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda; cpu runs "
                        "the kernels' plain PyTorch versions)")
    p.add_argument("--obj", default=None, metavar="PATH",
                   help="render a custom OBJ mesh instead of the preset cat")
    p.add_argument("--obj-scale", type=float, default=None,
                   help="uniform scale applied to the custom OBJ")
    p.add_argument("--obj-offset", type=float, nargs=3,
                   default=(0.0, 0.0, 0.0), metavar=("X", "Y", "Z"))
    p.add_argument("--clustering", default=None,
                   choices=["ref", "sah", "sah-pave", "ref-pave"],
                   help="pairs clustering (only ref is ported)")
    p.add_argument("--compact", type=float, default=None, metavar="FRAC")
    p.add_argument("--compact2", type=float, default=None, metavar="FRAC")
    p.add_argument("--compact3", type=float, default=None, metavar="FRAC")
    p.add_argument("--spp-unroll", type=int, default=None, metavar="N")
    p.add_argument("--chunk-unroll", type=int, default=None, metavar="N")
    p.add_argument("--depth-unroll", type=int, default=None, metavar="N")
    p.add_argument("--bvh-builder", default="reference",
                   choices=["reference", "lbvh"],
                   help="acceleration-structure builder")


def _refuse_unported(args) -> None:
    """Exit with a message naming the ROADMAP item for any flag that asks
    for a mode the port does not have."""
    for attr, inert, why in _UNPORTED_FLAGS:
        if getattr(args, attr) not in inert:
            raise SystemExit(f"error: {why}")
    if args.devices > 1:
        raise SystemExit("error: --devices > 1: multi-GPU rendering is not "
                         "ported yet (ROADMAP A13)")
    if args.traversal == "bvh":
        raise SystemExit("error: --traversal bvh is not ported yet "
                         "(ROADMAP A10b)")
    if args.preset not in PORTED_PRESETS:
        raise SystemExit(f"error: preset {args.preset!r} is not ported yet "
                         f"(ROADMAP A9; ported: {', '.join(PORTED_PRESETS)})")


def _build(args, device):
    """(config, scene tables on ``device``) from the common flags, through
    ``api.Renderer``."""
    _refuse_unported(args)
    over = dict(width=args.width, height=args.height)
    spp = args.spp_flag if args.spp_flag is not None else args.spp
    bounces = (args.bounces_flag if args.bounces_flag is not None
               else args.bounces)
    if spp is not None:
        over["spp"] = spp
    if bounces is not None:
        over["max_depth"] = bounces
    if args.traversal:
        over["traversal"] = args.traversal
    r = Renderer(args.preset, obj_path=args.obj, obj_scale=args.obj_scale,
                 obj_offset=args.obj_offset, bvh_builder=args.bvh_builder,
                 device=device, **over)
    return r.cfg, r.scene


def cmd_render(args) -> int:
    try:
        dev = render_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")
    cfg, tables = _build(args, dev)
    cam = Camera.default(cfg, dev)
    key = PRNGKey(args.seed, dev)

    def run():
        img, stats = render_frame(tables, cfg, cam, key)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return img, stats

    if args.profile:
        run()  # build the kernels and fill the allocator outside the trace
    t0 = time.perf_counter()
    with device_trace(args.profile):
        img, stats = run()
    wall = time.perf_counter() - t0
    if args.profile:
        print(f"profiler trace -> {args.profile}/trace.json (chrome://tracing"
              " or Perfetto)")

    out = args.out or f"image_{args.preset}.png"
    arr = img.cpu().numpy()
    if args.selfcheck:
        # a finite frame, and the same seed gives the same frame
        if not torch.isfinite(img).all():
            raise SystemExit("selfcheck failed: non-finite radiance")
        if not torch.equal(run()[0], img):
            raise SystemExit("selfcheck failed: nondeterministic render")
        print("selfcheck OK: finite + deterministic")
    write_png(out, tonemap(arr))
    rep = ray_report(stats, cfg.spp, cfg.width, cfg.height, wall)
    print(f"Rendering time: {wall:.3f} s on {dev}")  # reference print shape
    print(json.dumps(rep))
    print(f"wrote {out}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytracinggpu_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="single-frame render to PNG")
    _add_common(pr)
    pr.add_argument("--out", default=None)
    pr.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the render to DIR")
    pr.add_argument("--selfcheck", action="store_true",
                    help="validate the frame (finite, deterministic)")
    for name in ("realtime", "bench"):
        sub.add_parser(name, help="not ported yet (ROADMAP A12)")

    args = ap.parse_args(argv)
    if args.cmd != "render":
        raise SystemExit(f"error: the {args.cmd} subcommand is not ported "
                         "yet (ROADMAP A12)")
    try:
        return cmd_render(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
