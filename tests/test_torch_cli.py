"""The port's CLI (raytracinggpu_tpu_torch/cli/main.py): the cases of
tests/test_cli_obj.py on ``--device cpu``, the ``bench`` and ``realtime``
subcommands, the flags it refuses and the ported flags once refused
(``--clustering``, ``--traversal bvh``, ``--animate mesh|both``), its
refusal to render without a CUDA
device unless asked for the CPU, and the profiling helpers it reports
with (utils/profiling.py)."""
import json
import os

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


# the ROADMAP items whose flags were refused until they were ported
PORTED_ITEMS = ("A5", "A10b", "A13")


@pytest.mark.parametrize("flags,item", [
    (["--clustering", "sah"], "A10b"),
    (["--compact", "0.25"], "A5"),
    (["--devices", "2"], "A13"),
    (["--precision", "highest"], "Not to port"),
    (["--depth-unroll", "2"], "Not to port"),
    (["--traversal", "bvh"], "A10b"),
    (["--compact2", "0.5"], "A5"),
])
def test_unported_flags_exit_naming_the_roadmap_item(tmp_path, flags, item):
    """A flag of the JAX CLI whose mode the port lacks exits naming its
    ROADMAP item; the flags of a ported item (``--compact``,
    ``--compact2``: A5; ``--clustering``, ``--traversal bvh``: A10b;
    ``--devices 2``: A13, two CPU ranks) render."""
    out = str(tmp_path / "f.png")
    argv = ["render", "1", "1", "--width", "8", "--height", "8",
            "--device", "cpu", "--out", out, *flags]
    if item in PORTED_ITEMS:
        assert main(argv) == 0
        assert read_png(out).shape == (8, 8, 3)
    else:
        with pytest.raises(SystemExit, match=item):
            main(argv)


def test_compact_flags_render_the_default_image(tmp_path, monkeypatch):
    """--compact 0.25 sets the ladder's first tier, and --compact2 and
    --compact3 the others, as the JAX CLI does; the 48x48 spp 2 depth 3
    frame (casts of 4,608 rays, so that a tier is below a cast) is the
    default's bit for bit, with the tier taken on some casts."""
    import raytracinggpu_tpu_torch.ops.pairs_trace as pt

    taken = []
    tier = pt._tier
    monkeypatch.setattr(pt, "_tier",
                        lambda *a: taken.append(tier(*a)) or taken[-1])
    imgs = []
    for flags in ([], ["--compact", "0.25", "--compact2", "0.3",
                       "--compact3", "0"]):
        out = str(tmp_path / f"c{len(imgs)}.png")
        assert main(["render", "2", "3", "--width", "48", "--height", "48",
                     "--device", "cpu", "--out", out, *flags]) == 0
        imgs.append(read_png(out))
    np.testing.assert_array_equal(imgs[1], imgs[0])
    assert any(taken)
    with pytest.raises(SystemExit, match="--compact"):
        main(["bench", "1", "1", "--device", "cpu", "--compact", "0.25"])


def test_clustering_flags_build_the_jax_package_tables(monkeypatch):
    """--clustering TREE[-pave] sets pairs_cluster, and -pave also
    pairs_pack="pave" and pairs_cut=32, as the JAX CLI does."""
    import raytracinggpu_tpu_torch.cli.main as cli

    seen = {}

    class Probe:
        def __init__(self, preset, **kw):
            seen.clear()
            seen.update(kw)
            raise SystemExit(0)

    monkeypatch.setattr(cli, "Renderer", Probe)
    for flag, want in (("sah", dict(pairs_cluster="sah")),
                       ("sah-pave", dict(pairs_cluster="sah",
                                         pairs_pack="pave", pairs_cut=32)),
                       ("ref-pave", dict(pairs_cluster="ref",
                                         pairs_pack="pave", pairs_cut=32))):
        with pytest.raises(SystemExit):
            main(["render", "1", "1", "--device", "cpu", "--clustering",
                  flag])
        assert {k: seen.get(k) for k in want} == want
        if flag == "sah":
            assert "pairs_pack" not in seen and "pairs_cut" not in seen
    with pytest.raises(SystemExit, match="--clustering"):
        main(["bench", "1", "1", "--device", "cpu", "--clustering", "sah"])


def test_realtime_subcommand_is_not_ported(tmp_path, capsys):
    """Once refused (ROADMAP A11), now ported: ``--animate mesh`` (the
    light held still), ``--animate both`` and ``--mesh-speed`` spin the
    mesh; the checkpoint carries the mesh angle."""
    from raytracinggpu_tpu_torch.utils.checkpoint import load_state

    for i, flags in enumerate((["--animate", "mesh"], ["--animate", "both"],
                               ["--mesh-speed", "2.0"])):
        ck = str(tmp_path / f"s{i}.npz")
        rc = main(["realtime", "1", "1", "--width", "8", "--height", "8",
                   "--frames", "2", "--traversal", "bvh", "--device", "cpu",
                   "--checkpoint", ck, *flags])
        assert rc == 0
        st = load_state(ck, "cpu")
        summary = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert summary["frames"] == 2
        light0 = float(np.float32(np.arctan2(40.0, 0.0)))
        if flags[1] == "mesh":
            # the mesh turns 2 x 0.02 rad, the light stays
            assert float(st.mesh_angle) == pytest.approx(0.04, abs=1e-6)
            assert float(st.light_angle) == light0
        elif flags[1] == "both":
            assert float(st.mesh_angle) > 0.0
            assert float(st.light_angle) > light0
        else:  # --mesh-speed without --animate mesh moves nothing but light
            assert float(st.mesh_angle) == 0.0


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


def test_render_on_two_ranks_writes_the_png_of_one(tmp_path, capsys):
    """``render --device cpu --devices 2`` shards the rows over two CPU
    ranks (gloo); rank 0 alone reports, and its PNG is the one of
    ``--devices 1`` byte for byte (the frames are bitwise equal)."""
    argv = ["render", "2", "2", "--width", "16", "--height", "16",
            "--device", "cpu", "--seed", "5"]
    one, two = str(tmp_path / "one.png"), str(tmp_path / "two.png")
    assert main([*argv, "--out", one]) == 0
    capsys.readouterr()
    assert main([*argv, "--devices", "2", "--out", two, "--selfcheck"]) == 0
    out = capsys.readouterr().out
    assert "launch: 2 ranks on cpu, cpu over gloo" in out
    with open(one, "rb") as f, open(two, "rb") as g:
        assert f.read() == g.read()


def test_render_devices_on_cuda_without_a_card_exits():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(SystemExit, match="no CUDA device"):
        main(["render", "1", "1", "--width", "8", "--height", "8",
              "--devices", "2"])


@pytest.mark.parametrize("argv,words", [
    (["render", "--height", "15", "--devices", "2"], ("15", "px = 2")),
    (["render", "--devices", "0"], ("--devices 0",)),
    (["realtime", "--devices", "2"], ("realtime and bench run on one",)),
    (["bench", "--devices", "2"], ("realtime and bench run on one",)),
])
def test_devices_that_cannot_shard_are_refused(argv, words, capsys):
    """A height that the ranks do not divide, no rank at all, and
    ``--devices`` on the subcommands that render on one device exit with
    an error before any rank starts."""
    argv = [*argv, "1", "1", "--device", "cpu", "--width", "8"]
    try:
        rc = main(argv)
        msg = capsys.readouterr().err
    except SystemExit as e:
        rc, msg = 1, str(e)
    assert rc == 1
    assert all(w in msg for w in words)
