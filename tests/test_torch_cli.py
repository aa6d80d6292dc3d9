"""The port's render CLI (raytracinggpu_tpu_torch/cli/main.py): the cases
of tests/test_cli_obj.py on ``--device cpu``, the flags it refuses, its
refusal to render without a CUDA device unless asked for the CPU, and the
profiling helpers it reports with (utils/profiling.py)."""
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
    (["--preset", "global"], "A9"),
])
def test_unported_flags_exit_naming_the_roadmap_item(flags, item):
    with pytest.raises(SystemExit, match=item):
        main(["render", "1", "1", "--width", "8", "--height", "8",
              "--device", "cpu", *flags])


def test_realtime_subcommand_is_not_ported():
    with pytest.raises(SystemExit, match="A12"):
        main(["realtime"])


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
