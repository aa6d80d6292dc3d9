"""The port's sharded frame (raytracinggpu_tpu_torch/parallel/sharding.py)
on CPU ranks over gloo.

One world of four spawned ranks (``sharding.launch``, a ``file://`` store
in a temporary directory, no fixed port, one thread a rank) renders every
case on its mesh and writes each rank's frame; it also renders each
case's single-device ``render_frame``, spread over the ranks.  Each case
is held BITWISE: every rank's gathered frame equals the single-device
frame, and the world-summed TraceStats equal its stats.  The port adds a
pixel's samples in global sample order on any mesh, so the JAX package's
alignment rule (spp_fuse == spp // sp, tests/test_sharding_bitwise.py)
does not apply: most cases are not aligned.

Against the JAX package's ``render_frame_sharded`` on a (2, 2) mesh of
its virtual CPU devices, the port's (2, 2) frame is held at the per-frame
standard of tests/test_golden.py: fewer than 0.5% of pixels off by more
than 1e-4*|g| + 1.0.

The ranks import this module to find ``_world``: the JAX package is
imported inside the one test that needs it.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from raytracinggpu_tpu_torch import Renderer
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.parallel.multihost_demo import dryrun_legs
from raytracinggpu_tpu_torch.parallel.sharding import (
    DeviceMesh,
    backend_for,
    initialize_multihost,
    launch,
    make_mesh,
    rank_devices,
    render_frame_sharded,
)
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    render_frame,
    render_rows,
    sample_colors,
    sum_samples,
)
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

RANKS = 4
SEED = 3
SIZE = dict(width=16, height=16, spp=4, max_depth=2)
MESHES = ((4, 1), (2, 2), (1, 4))
# a hung rank fails the fixture long before Tier-1's limit; the world takes
# about 30 s alone
WORLD_TIMEOUT = 300.0

# name: (preset, config overrides, mesh; None = Renderer.render_sharded's
# default mesh over the world)
CASES = {
    **{f"global-dense-{px}x{sp}-fuse{f}":
       ("global", dict(SIZE, traversal="dense", spp_fuse=f), (px, sp))
       for px, sp in MESHES for f in (1, 2, 4)},
    **{f"array_bvh-{t}-2x2": ("array_bvh", dict(SIZE, traversal=t), (2, 2))
       for t in ("pairs", "pallas", "bvh")},
    # the dense leg at an eighth of its width, its casts padded to 128 rays
    # instead of 4096 (a ray's result does not depend on its cast, and the
    # plain versions on the CPU take the time of the padded cast); the
    # pairs leg (128-ray casts of its own) at half its width, where its
    # ranks' casts compact (tests/test_torch_compact.py)
    "dryrun-dense-2x2": ("array_bvh", dict(dryrun_legs(shrink=8)[0],
                                           pairs_block=128), (2, 2)),
    "dryrun-pairs-2x2": ("array_bvh", dryrun_legs(shrink=2)[1], (2, 2)),
    "renderer-default-mesh": ("array_bvh", dict(SIZE, traversal="dense"),
                              None),
}
# rough single-thread cost a ray of each traversal on the CPU, to spread
# the single-device frames over the ranks
_COST = {"dense": 1, "pairs": 10, "pallas": 3, "bvh": 1}


def _owners() -> dict:
    """case -> the rank that renders its single-device frame: the
    costliest first, each to the least loaded rank."""
    load = [0.0] * RANKS
    cost = {n: o["width"] * o["height"] * o["spp"]
            * _COST[o.get("traversal", "pairs")]
            for n, (_, o, _) in CASES.items()}
    owners = {}
    for n in sorted(cost, key=lambda n: (-cost[n], n)):
        r = load.index(min(load))
        owners[n] = r
        load[r] += cost[n]
    return owners


def _save(path, img, stats):
    np.savez(path, img=np.asarray(img), stats=np.stack([np.asarray(s)
                                                        for s in stats]))


def _world(device, out_dir):
    """One rank: every case sharded, then the single-device frames it
    owns."""
    torch.set_num_threads(1)
    rank = dist.get_rank()
    meshes = {shape: make_mesh(*shape, device=device) for shape in MESHES}
    for name, (preset, over, shape) in CASES.items():
        if shape is None:
            r = Renderer(preset, device=device, **over)
            img, stats = r.render_sharded(seed=SEED)
        else:
            cfg, tables = build_preset(preset, device, **over)
            img, stats = render_frame_sharded(
                tables, cfg, Camera.default(cfg, device),
                PRNGKey(SEED, device), meshes[shape])
        _save(os.path.join(out_dir, f"{name}.rank{rank}.npz"), img, stats)
    for name, owner in _owners().items():
        if owner != rank:
            continue
        preset, over, _ = CASES[name]
        cfg, tables = build_preset(preset, device, **over)
        img, stats = render_frame(tables, cfg, Camera.default(cfg, device),
                                  PRNGKey(SEED, device))
        _save(os.path.join(out_dir, f"{name}.ref.npz"), img, stats)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("world")
    assert launch(_world, ["cpu"] * RANKS, str(out),
                  timeout=WORLD_TIMEOUT) == 0
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_frame_is_the_single_device_frame(world, name):
    ref = np.load(world / f"{name}.ref.npz")
    assert np.isfinite(ref["img"]).all()
    for rank in range(RANKS):
        got = np.load(world / f"{name}.rank{rank}.npz")
        np.testing.assert_array_equal(got["img"], ref["img"])
        np.testing.assert_array_equal(got["stats"], ref["stats"])


def test_cases_are_mostly_not_aligned():
    """The JAX rule's aligned cases (spp_fuse == spp // sp) are the
    minority: the port needs no alignment."""
    aligned = [n for n, (_, o, m) in CASES.items()
               if m is not None and o.get("spp_fuse") == o["spp"] // m[1]]
    assert 0 < len(aligned) < len(CASES) / 2


def test_sharded_frame_meets_the_jax_sharded_frame(world):
    import jax

    from raytracinggpu_tpu.parallel.sharding import (
        make_mesh as j_make_mesh,
        render_frame_sharded as j_render_frame_sharded,
    )
    from raytracinggpu_tpu.render.pipeline import Camera as JCamera
    from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset

    cfg, tables = j_build_preset("global", traversal="dense", **SIZE)
    mesh = j_make_mesh(2, 2, devices=jax.devices()[:4])
    jimg, jstats = j_render_frame_sharded(
        tables, cfg, JCamera.default(cfg), jax.random.PRNGKey(SEED), mesh)
    jimg = np.asarray(jimg)
    got = np.load(world / "global-dense-2x2-fuse2.rank0.npz")
    img = got["img"]
    bad = np.abs(img - jimg) > 1e-4 * np.abs(jimg) + 1.0
    assert bad.any(-1).mean() < 0.005
    n = cfg.width * cfg.height * cfg.spp
    assert np.asarray(jstats.hit).tolist() == [n] * cfg.max_depth
    # the world-summed counts are integers: the JAX mesh's, per depth
    np.testing.assert_array_equal(
        got["stats"], np.stack([np.asarray(s) for s in jstats]))


@pytest.mark.parametrize("shape,words", [((3, 1), ("16", "px = 3")),
                                         ((1, 3), ("spp 4", "sp = 3"))])
def test_a_mesh_that_does_not_divide_the_frame_is_refused(shape, words):
    cfg, tables = build_preset("array_bvh", "cpu", **SIZE)
    mesh = DeviceMesh(*shape, 0, 0, torch.device("cpu"))
    with pytest.raises(ValueError) as e:
        render_frame_sharded(tables, cfg, Camera.default(cfg, "cpu"),
                             PRNGKey(0, "cpu"), mesh)
    assert all(w in str(e.value) for w in words)


def test_a_mesh_larger_than_the_world_is_refused():
    with pytest.raises(ValueError, match="needs 2 ranks; the world has 1"):
        make_mesh(2, 1, device="cpu")


def test_initialize_multihost_without_a_group_is_a_world_of_one():
    mesh = initialize_multihost(device="cpu")
    assert (mesh.n_px, mesh.n_sp, mesh.rank) == (1, 1, 0)
    assert mesh.px_group is None and mesh.sp_group is None
    cfg, tables = build_preset("array_bvh", "cpu", width=8, height=8, spp=2,
                               max_depth=1, traversal="dense")
    cam, key = Camera.default(cfg, "cpu"), PRNGKey(0, "cpu")
    img, stats = render_frame_sharded(tables, cfg, cam, key, mesh)
    ref, ref_stats = render_frame(tables, cfg, cam, key)
    assert torch.equal(img, ref)
    assert all(torch.equal(a, b) for a, b in zip(stats, ref_stats))


@pytest.mark.parametrize("fuse", [1, 2, 3])
def test_sample_colors_sum_to_render_rows(fuse):
    """The sharded path's per-sample colours, added in order, are
    render_rows' accumulator bit for bit, whatever the wavefront grouping;
    each sample is the one render_rows traces."""
    cfg, tables = build_preset("array_bvh", "cpu", width=8, height=8, spp=3,
                               max_depth=2, spp_fuse=fuse, traversal="dense")
    cam, key = Camera.default(cfg, "cpu"), PRNGKey(1, "cpu")
    rows = np.arange(2, 6, dtype=np.int32)
    acc, stats = render_rows(tables, cfg, cam, key, rows, range(3))
    cols, cstats = sample_colors(tables, cfg, cam, key, rows, range(3))
    assert cols.shape == (3, 3, 4 * 8)
    assert all(torch.equal(a, b) for a, b in zip(sum_samples(cols), acc))
    assert all(torch.equal(a, b) for a, b in zip(stats, cstats))
    one, _ = render_rows(tables, cfg, cam, key, rows, [1])
    assert all(torch.equal(a, b) for a, b in zip(one, cols[1]))


def test_backends_and_rank_devices():
    assert backend_for(["cpu"] * 4) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"  # one shared card
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert rank_devices("cpu", 3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rank_devices("cuda", 2)
