"""The port's multi-process demo and multichip dry run
(raytracinggpu_tpu_torch/parallel/multihost_demo.py) and the launcher
under them (parallel/sharding.launch), on CPU ranks over gloo.

The demo's rank 0 holds the gathered frame BITWISE against a
single-process render (the JAX demo, tests/test_multihost.py, allows a
tolerance); so does each process of a world joined through
``initialize_multihost``.  A rank that fails or hangs makes the launcher
return nonzero and stops the others.  Every world has its own timeout.
"""
import multiprocessing as mp
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.parallel.multihost_demo import (
    dryrun_multichip,
    launch,
    main,
)
from raytracinggpu_tpu_torch.parallel.sharding import (
    initialize_multihost,
    launch as launch_fn,
    render_frame_sharded,
)
from raytracinggpu_tpu_torch.render.pipeline import Camera, render_frame
from raytracinggpu_tpu_torch.scene.presets import build_preset

TIMEOUT = 240.0


def _fail_on_rank1(device):
    if dist.get_rank() == 1:
        raise SystemExit("rank 1 fails")
    dist.barrier()


def _hang_on_rank1(device):
    if dist.get_rank() == 1:
        time.sleep(600)
    dist.barrier()


def _multihost_rank(coordinator, process_id, out_path):
    """One process of a two-process world joined through
    ``initialize_multihost``, as one process a host would join it."""
    torch.set_num_threads(1)
    mesh = initialize_multihost(coordinator, 2, process_id, device="cpu")
    try:
        cfg, tables = build_preset("array_bvh", "cpu", width=8, height=8,
                                   spp=2, max_depth=2, traversal="dense")
        cam, key = Camera.default(cfg, "cpu"), PRNGKey(2, "cpu")
        img, _ = render_frame_sharded(tables, cfg, cam, key, mesh)
        ref, _ = render_frame(tables, cfg, cam, key)
        np.save(out_path, np.array([mesh.n_px, mesh.n_sp, mesh.rank,
                                    int(torch.equal(img, ref))]))
    finally:
        dist.destroy_process_group()


def test_initialize_multihost_joins_a_world_of_two(tmp_path):
    """Two processes meet at a coordinator's host:port (a free port of
    this machine): a (1, 2) mesh, each holding the single-process frame
    bit for bit."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        coordinator = f"127.0.0.1:{sock.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    outs = [str(tmp_path / f"p{i}.npy") for i in range(2)]
    procs = [ctx.Process(target=_multihost_rank, args=(coordinator, i,
                                                        outs[i]))
             for i in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT)
        assert [p.exitcode for p in procs] == [0, 0]
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
                p.join()
    for i, out in enumerate(outs):
        assert np.load(out).tolist() == [1, 2, i, 1]


def test_initialize_multihost_needs_a_coordinator():
    with pytest.raises(ValueError, match="coordinator"):
        initialize_multihost(None, 2, 0, device="cpu")


def test_demo_launch_holds_the_gathered_frame_bitwise(tmp_path):
    out = tmp_path / "demo.txt"
    assert launch(device="cpu", out_path=str(out), timeout=TIMEOUT) == 0
    msg = out.read_text()
    assert msg.startswith("multihost OK: 4 processes on cpu, mesh px=2 sp=2")
    assert "gathered == single-process BITWISE" in msg


def test_dryrun_multichip_passes_both_legs(capfd):
    """Two ranks, a (1, 2) mesh, the legs at an eighth of their width."""
    assert dryrun_multichip(2, "cpu", shrink=8, timeout=TIMEOUT) == 0
    out = capfd.readouterr().out
    assert "launch: 2 ranks on cpu, cpu over gloo" in out
    for leg in ("dense", "pairs"):
        assert (f"dryrun_multichip OK [{leg}]: mesh px=1 sp=2 on cpu" in out)
    assert out.count("sharded == single-device BITWISE") == 2


def test_demo_without_a_card_exits_with_an_error(capfd):
    assert main(["--device", "cuda", "--processes", "2"]) == 1
    assert "no CUDA device" in capfd.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--dryrun", "2"]])
def test_demo_runs_on_the_card_by_default(argv, capfd):
    """With no --device the demo and the dry run ask for the card, and
    exit with an error where there is none: they never drop to the CPU."""
    assert main(argv) == 1
    assert "no CUDA device" in capfd.readouterr().err


def test_a_failing_rank_fails_the_launch(capfd):
    t0 = time.monotonic()
    assert launch_fn(_fail_on_rank1, ["cpu"] * 3, timeout=TIMEOUT) == 1
    assert time.monotonic() - t0 < TIMEOUT / 2  # not left to time out
    assert "launch: ranks exited with" in capfd.readouterr().err


def test_a_hung_rank_fails_the_launch_at_its_timeout(capfd):
    t0 = time.monotonic()
    assert launch_fn(_hang_on_rank1, ["cpu"] * 2, timeout=6.0) == 1
    assert time.monotonic() - t0 < 60.0  # the hung rank was stopped
    assert "still running after 6.0 s" in capfd.readouterr().err
