"""The port's CLI (raytracinggpu_tpu_torch/cli/main.py): the cases of
tests/test_cli_obj.py on ``--device cpu``, the ``bench`` and ``realtime``
subcommands, the flags it refuses, its refusal to render without a CUDA
device unless asked for the CPU, and the profiling helpers it reports
with (utils/profiling.py)."""
import json
import os
import time

import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.cli.main import main
from raytracinggpu_tpu_torch.render.image_io import read_png

torch.set_num_threads(2)

QUAD = "v -10 -8 -10\nv 10 -8 -10\nv 10 -8 10\nv -10 -8 10\nf 4 3 2 1\n"


def test_render_custom_obj(tmp_path, capsys):
    # A ground-plane quad mesh instead of the cat, wound so that its
    # geometric normal points up (the reference never flips mesh normals
    # toward the viewer; a downward normal would self-shadow to black).
    p = tmp_path / "quad.obj"
    p.write_text(QUAD)
    out = str(tmp_path / "o.png")
    rc = main(["render", "2", "2", "--preset", "array_bvh", "--width", "16",
               "--height", "16", "--obj", str(p), "--traversal", "pallas",
               "--device", "cpu", "--out", out, "--selfcheck"])
    assert rc == 0
    img = read_png(out)
    assert img.shape == (16, 16, 3)
    # The flat (zero-thickness box) quad must be visible: a strict slab
    # test would cull the planar tile.  Only the gray mesh has red ==
    # green energy (the walls here are pure green or blue).
    region = img[8:12, :, :].astype(int)
    mesh_px = (region[..., 0] > 60) & (abs(region[..., 0] - region[..., 1])
                                       < 25)
    assert mesh_px.sum() >= 3, "flat mesh not visible (culled?)"
    lines = capsys.readouterr().out.splitlines()
    assert "selfcheck OK: finite + deterministic" in lines
    rep = json.loads(next(ln for ln in lines if ln.startswith("{")))
    assert rep["primary_rays"] == 16 * 16 * 2
    assert len(rep["bounce_histogram"]) == 2
    assert rep["bounce_histogram"][0] == 16 * 16 * 2


def test_render_lbvh_builder_with_profile(tmp_path):
    out = str(tmp_path / "l.png")
    prof = str(tmp_path / "trace")
    rc = main(["render", "1", "2", "--preset", "array_bvh", "--width", "16",
               "--height", "16", "--bvh-builder", "lbvh", "--device", "cpu",
               "--out", out, "--profile", prof])
    assert rc == 0
    assert os.path.exists(out)
    assert os.path.getsize(os.path.join(prof, "trace.json")) > 0


def test_showcase_rejects_custom_obj(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    with pytest.raises(SystemExit, match="showcase"):
        main(["render", "1", "1", "--preset", "showcase", "--width", "8",
              "--height", "8", "--obj", str(p), "--device", "cpu"])


@pytest.mark.parametrize("flags,item", [
    (["--clustering", "sah"], "A10b"),
    (["--compact", "0.25"], "A5"),
    (["--devices", "2"], "A13"),
    (["--precision", "highest"], "Not to port"),
    (["--depth-unroll", "2"], "Not to port"),
    (["--traversal", "bvh"], "A10b"),
    (["--compact2", "0.5"], "A5"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        main(["render", "1", "1", "--width", "8", "--height", "8",
              "--device", "cpu", *flags])


def test_realtime_subcommand_is_not_ported():
    """What of ``realtime`` is still not ported: the animated mesh."""
    for flags in (["--animate", "mesh"], ["--animate", "both"],
                  ["--mesh-speed", "2.0"]):
        with pytest.raises(SystemExit, match="A11"):
            main(["realtime", "--device", "cpu", *flags])


def test_ray_report_matches_the_jax_package():
    # the CLI's JSON line: the port's ray_report on tensor stats against
    # the JAX package's on the same counts as numpy arrays
    from raytracinggpu_tpu.utils.profiling import ray_report as jax_report
    from raytracinggpu_tpu_torch.integrator.wavefront import TraceStats
    from raytracinggpu_tpu_torch.utils.profiling import ray_report

    rng = np.random.default_rng(0)
    counts = rng.integers(0, 1000, (len(TraceStats._fields), 3))
    stats = TraceStats(*(torch.from_numpy(c) for c in counts))
    stats_np = TraceStats(*counts)
    assert ray_report(stats, 4, 16, 8, 0.25) == jax_report(stats_np, 4, 16, 8,
                                                           0.25)
    assert ray_report(stats, 4, 16, 8, 0.0)["mrays_per_sec"] == 0.0


def test_phase_timer_accumulates_named_phases():
    from raytracinggpu_tpu_torch.utils.profiling import PhaseTimer

    pt = PhaseTimer()
    for name in ("build", "render", "build"):
        with pt.phase(name):
            time.sleep(0.01)
    assert list(pt.phases) == ["build", "render"]
    assert pt.phases["build"] >= 0.02 and pt.phases["render"] >= 0.01
    rep = pt.report()
    assert rep.startswith("build: ") and " | render: " in rep and "%)" in rep


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device='cpu'"):
        main(["render", "1", "1", "--width", "8", "--height", "8"])


@pytest.mark.parametrize("cmd", ["bench", "realtime"])
def test_default_device_needs_cuda_in_every_subcommand(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="device='cpu'"):
        main([cmd, "1", "1", "--width", "8", "--height", "8"])


@pytest.mark.parametrize("preset", ["global", "showcase"])
def test_render_the_other_presets(tmp_path, capsys, preset):
    out = str(tmp_path / "p.png")
    rc = main(["render", "1", "2", "--preset", preset, "--width", "12",
               "--height", "12", "--device", "cpu", "--out", out,
               "--selfcheck"])
    assert rc == 0 and read_png(out).shape == (12, 12, 3)
    rep = json.loads(next(ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("{")))
    assert rep["bounce_histogram"] == [144, 144]  # enclosed: every ray hits


def test_bench_positionals_restrict_the_sweep_to_one_cell(tmp_path, capsys):
    out = str(tmp_path / "sweep.json")
    rc = main(["bench", "2", "1", "--preset", "cpu", "--width", "16",
               "--height", "16", "--repeats", "2", "--device", "cpu",
               "--out", out])
    assert rc == 0
    with open(out) as f:
        cells = json.load(f)
    assert list(cells) == ["2x1"]
    assert list(cells["2x1"]) == ["first_s", "steady_s", "mrays"]
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("spp=   2 bounces= 1: ")
    assert lines[1] == "\truntime matrix (s): rows=spp, cols=bounces"


def test_bench_lists_and_default_traversal(monkeypatch):
    """--spps/--bounce-list give the grid, the traversal defaults to the
    production kernels' (``pairs``), flags win over positionals."""
    import raytracinggpu_tpu_torch.cli.main as cli

    seen = {}
    monkeypatch.setattr(cli, "run_sweep", lambda **kw: seen.update(kw))
    assert main(["bench", "--spps", "1,4", "--bounce-list", "2,3",
                 "--device", "cpu"]) == 0
    assert (seen["spps"], seen["bounces"], seen["traversal"],
            seen["preset"], seen["repeats"]) == ([1, 4], [2, 3], "pairs",
                                                 "array_bvh", 5)
    assert seen["device"] == torch.device("cpu")
    main(["bench", "8", "3", "--spp", "2", "--traversal", "pallas",
          "--device", "cpu"])
    assert (seen["spps"], seen["bounces"], seen["traversal"]) == (
        [2], [3], "pallas")
    with pytest.raises(SystemExit, match="render"):
        main(["bench", "--obj", "x.obj", "--device", "cpu"])


def test_realtime_frames_checkpoint_and_last_frame(tmp_path, capsys):
    """``realtime --frames 2 --out-dir``: two PNGs, the summary line, a
    checkpoint; the last frame is ``run_loop``'s."""
    from raytracinggpu_tpu_torch.render.realtime import run_loop
    from raytracinggpu_tpu_torch.scene.presets import build_preset
    from raytracinggpu_tpu_torch.utils.checkpoint import load_state

    d, ck = tmp_path / "frames", str(tmp_path / "state.npz")
    size = ["--width", "16", "--height", "16"]
    rc = main(["realtime", "2", "2", "--frames", "2", "--out-dir", str(d),
               "--checkpoint", ck, "--device", "cpu", "--light-speed", "2.0",
               *size])
    assert rc == 0
    assert sorted(os.listdir(d)) == ["frame_00000.png", "frame_00001.png"]
    lines = capsys.readouterr().out.splitlines()
    summary = json.loads(lines[-1])
    assert summary["frames"] == 2 and lines[-2] == f"checkpoint -> {ck}"
    cfg, tables = build_preset("realtime", "cpu", width=16, height=16, spp=2,
                               max_depth=2)
    want_dir = tmp_path / "want"
    state, _ = run_loop(tables, cfg, 2, seed=0, out_dir=str(want_dir),
                        print_every=0, angular_speed=2.0)
    np.testing.assert_array_equal(
        read_png(str(d / "frame_00001.png")),
        read_png(str(want_dir / "frame_00001.png")))
    got = load_state(ck, "cpu")
    assert torch.equal(got.accum, state.accum) and int(got.frames) == 2
    assert float(got.light_angle) == float(state.light_angle)


def test_realtime_raw_streams_rgb24_and_batches(tmp_path, capsysbinary):
    """--raw writes H*W*3 bytes a frame to stdout and the summary to
    stderr; --frames-per-dispatch 2 streams the same bytes."""
    streams = []
    for g in ("1", "2"):
        rc = main(["realtime", "1", "1", "--frames", "2", "--raw",
                   "--frames-per-dispatch", g, "--width", "8", "--height",
                   "8", "--device", "cpu"])
        cap = capsysbinary.readouterr()
        assert rc == 0 and len(cap.out) == 2 * 8 * 8 * 3
        assert json.loads(cap.err.decode().splitlines()[-1])["frames"] == 2
        streams.append(cap.out)
    assert streams[0] == streams[1]


def test_realtime_interactive_follows_keys(tmp_path, monkeypatch, capsys):
    """--interactive on a pseudo-terminal: keys typed during the first
    frame (a move, then q) are both read after it, and q quits before any
    frame is read back; without keys the loop runs its frames and leaves
    the live frame."""
    import pty

    import raytracinggpu_tpu_torch.cli.main as cli

    args = ["realtime", "1", "1", "--interactive", "--out-dir", str(tmp_path),
            "--width", "8", "--height", "8", "--device", "cpu"]
    master, slave = pty.openpty()
    real_step, calls = cli.step, []

    def typing_step(*a, **kw):
        if not calls:  # after the loop has put the terminal in cbreak mode
            os.write(master, b"dq")
        calls.append(1)
        return real_step(*a, **kw)

    monkeypatch.setattr(cli, "step", typing_step)
    with os.fdopen(slave, "r") as tty_in:
        monkeypatch.setattr("sys.stdin", tty_in)
        assert main([*args, "--frames", "20"]) == 0
        assert len(calls) == 1
        assert "interactive: writing" in capsys.readouterr().out
        assert not os.path.exists(tmp_path / "live.png")
        monkeypatch.setattr(cli, "step", real_step)
        assert main([*args, "--frames", "3"]) == 0
    os.close(master)
    assert read_png(str(tmp_path / "live.png")).shape == (8, 8, 3)
