"""Command-line frontend (port of ``raytracinggpu_tpu/cli/main.py``): the
``render``, ``realtime`` and ``bench`` subcommands.

    python -m raytracinggpu_tpu_torch.cli render --preset array_bvh 32 5 \
        --out img.png
    python -m raytracinggpu_tpu_torch.cli render 4 2 --obj mesh.obj \
        --bvh-builder lbvh --selfcheck
    python -m raytracinggpu_tpu_torch.cli render 2 2 --device cpu
    python -m raytracinggpu_tpu_torch.cli realtime --frames 60 \
        --out-dir frames/
    python -m raytracinggpu_tpu_torch.cli bench 32 5 --preset array_bvh

``render`` writes one frame as a PNG, ``realtime`` runs the progressive
loop with the circulating light (PNG sequence, raw RGB24 pipe, or
``--interactive`` with the reference's key bindings), ``bench`` sweeps
spp x bounces (``bench/sweep.py``; positional spp and bounces restrict it
to one cell).  Everything renders on ``--device``, the CUDA device by
default; without one the command exits with an error unless ``--device
cpu`` is given.  A flag of the JAX CLI whose mode the port does not have
exits with a message naming its ROADMAP item; none is ignored.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from raytracinggpu_tpu_torch.api import Renderer, render_device
from raytracinggpu_tpu_torch.bench.sweep import run_sweep
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.render.image_io import tonemap, write_png
from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
from raytracinggpu_tpu_torch.render.realtime import (
    init_state,
    on_key,
    run_loop,
    step,
    steps,
)
from raytracinggpu_tpu_torch.scene.presets import PRESET_NAMES
from raytracinggpu_tpu_torch.utils.checkpoint import save_state
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
    if args.obj and args.preset == "showcase":
        raise SystemExit("error: --obj is not supported with --preset "
                         "showcase (the showcase scene has no mesh slot)")


def _spp_bounces(args):
    """(spp, bounces) as given, None where not: ``--spp``/``--bounces``
    win over the positionals."""
    return (args.spp_flag if args.spp_flag is not None else args.spp,
            args.bounces_flag if args.bounces_flag is not None
            else args.bounces)


def _build(args, device):
    """(config, scene tables on ``device``) from the common flags, through
    ``api.Renderer``."""
    _refuse_unported(args)
    over = dict(width=args.width, height=args.height)
    spp, bounces = _spp_bounces(args)
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


def _device(args) -> torch.device:
    try:
        return render_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"error: {e}")


def cmd_render(args) -> int:
    dev = _device(args)
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


def cmd_realtime(args) -> int:
    if args.animate != "light" or args.mesh_speed != 1.0:
        raise SystemExit("error: --animate mesh/both and --mesh-speed: mesh "
                         "posing (pose_mesh) is not ported yet (ROADMAP A11)")
    cfg, tables = _build(args, _device(args))
    if args.interactive:
        for flag in ("checkpoint", "raw"):
            if getattr(args, flag):
                print(f"warning: --{flag} is ignored with --interactive",
                      file=sys.stderr)
        return _interactive_loop(tables, cfg, args)
    state, summary = run_loop(
        tables, cfg, n_frames=args.frames, seed=args.seed,
        out_dir=args.out_dir,
        raw_pipe=sys.stdout.buffer if args.raw else None,
        angular_speed=args.light_speed,
        frames_per_dispatch=args.frames_per_dispatch)
    info = sys.stderr if args.raw else sys.stdout
    if args.checkpoint:
        save_state(args.checkpoint, state)
        print(f"checkpoint -> {args.checkpoint}", file=info)
    print(json.dumps(summary), file=info)
    return 0


def _interactive_loop(tables, cfg, args) -> int:
    """Terminal-interactive progressive rendering, the GL-free equivalent
    of the reference's GLUT loop.  Its key bindings (a/d/r/f/w/s translate,
    h/l/k/j = arrow yaw/pitch, q or ESC quits) apply between dispatches;
    the latest display is written to <--out-dir>/live.png (default
    ./live.png) for an image viewer to follow.  One dispatch stays in
    flight: frame n + 1 is enqueued before frame n is read back."""
    import select
    import termios
    import tty

    keymap = {"h": "left", "l": "right", "k": "up", "j": "down"}
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)
        out = os.path.join(args.out_dir, "live.png")
    else:
        out = "live.png"
    g = max(1, args.frames_per_dispatch)
    speed = np.float32(args.light_speed)
    state = init_state(cfg, tables, seed=args.seed)
    fd = sys.stdin.fileno()
    old = termios.tcgetattr(fd)
    print(f"interactive: writing {out}; keys a/d r/f w/s move, h/l/k/j "
          "look, q quits")
    try:
        tty.setcbreak(fd)
        i = 0
        pending = None  # the previous dispatch's newest display, not read
        t0 = time.perf_counter()
        while args.frames <= 0 or i < args.frames:
            if g == 1:
                state, display = step(tables, cfg, state, angular_speed=speed)
            else:
                # g frames a dispatch: keys apply every g frames
                state, batch = steps(tables, cfg, g, state, speed)
                display = batch[-1]
            if pending is not None:
                shown = pending.cpu().numpy()  # waits for that dispatch
                t1 = time.perf_counter()
                dt = (t1 - t0) / g
                t0 = t1
                write_png(out, shown)
                if ((i - g) // g) % max(1, 5 // g) == 0:
                    print(f"frame {i - g}: {dt * 1e3:.0f} ms "
                          f"({1 / dt:.2f} FPS)", flush=True)
            pending = display
            # keys are read from the descriptor, one byte at a time: a
            # buffered read would hold back a second key typed in the
            # same frame until the next key press
            while select.select([fd], [], [], 0)[0]:
                ch = os.read(fd, 1).decode("latin-1")
                if ch in ("q", "\x1b", ""):
                    return 0
                state = on_key(state, keymap.get(ch, ch))
            i += g
        if pending is not None:
            write_png(out, pending.cpu().numpy())
    finally:
        termios.tcsetattr(fd, termios.TCSADRAIN, old)
    return 0


def cmd_bench(args) -> int:
    _refuse_unported(args)
    if args.obj or args.bvh_builder != "reference":
        raise SystemExit("error: bench sweeps a preset's own scene; --obj "
                         "and --bvh-builder belong to render (custom "
                         "meshes: bench/big_mesh.py)")
    # Positional spp/bounces (reference CLI shape: `bench 4 2`) restrict
    # the sweep to that single cell instead of being silently ignored.
    spp, bounces = _spp_bounces(args)
    run_sweep(
        preset=args.preset, width=args.width, height=args.height,
        spps=[int(spp)] if spp is not None
        else [int(s) for s in args.spps.split(",")],
        bounces=[int(bounces)] if bounces is not None
        else [int(b) for b in args.bounce_list.split(",")],
        repeats=args.repeats,
        # the production kernels by default, as `render` runs
        traversal=args.traversal or "pairs",
        out=args.out, device=_device(args))
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

    pt = sub.add_parser("realtime",
                        help="progressive loop with circulating light")
    _add_common(pt)
    pt.set_defaults(preset="realtime")
    pt.add_argument("--frames", type=int, default=30)
    pt.add_argument("--out-dir", default=None)
    pt.add_argument("--raw", action="store_true",
                    help="stream raw RGB24 frames to stdout (ffmpeg pipe)")
    pt.add_argument("--light-speed", type=float, default=1.0)
    pt.add_argument("--animate", choices=["light", "mesh", "both"],
                    default="light",
                    help="per-frame animation (only the circulating light "
                         "is ported)")
    pt.add_argument("--mesh-speed", type=float, default=1.0)
    pt.add_argument("--checkpoint", default=None)
    pt.add_argument("--interactive", action="store_true",
                    help="terminal-interactive camera (GLUT-equivalent keys)")
    pt.add_argument("--frames-per-dispatch", type=int, default=1,
                    metavar="G",
                    help="enqueue G frames before reading any back; the "
                         "frames are bitwise those of G = 1, key events "
                         "apply every G frames")

    pb = sub.add_parser("bench", help="benchmark sweep (benchmark.py parity)")
    _add_common(pb)
    pb.add_argument("--spps", default="1,2,4,8,16,32,64,128,256")
    pb.add_argument("--bounce-list", default="1,2,3,4,5,6,7,8,9,10")
    pb.add_argument("--repeats", type=int, default=5)
    pb.add_argument("--out", default=None)

    args = ap.parse_args(argv)
    cmd = {"render": cmd_render, "realtime": cmd_realtime,
           "bench": cmd_bench}[args.cmd]
    try:
        return cmd(args)
    except FileNotFoundError as e:
        print(f"error: file not found: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
