"""The port's integrator against its numpy oracle
(raytracinggpu_tpu_torch/oracle/numpy_ref.py, the cases of
raytracinggpu_tpu_torch/oracle/cases.py).

- The port's copy of the oracle is the JAX package's, bit for bit: the
  same tables and the same trace on every case below.
- The port's ``trace`` on the CPU, with the injected uniforms of each case,
  against the oracle under the bound of tests/test_fuzz_oracle.py and
  tests/test_realtime_differential.py: a ray disagrees when a channel is
  off by more than 3e-3 * |ref| + 3.0, and fewer than 4% of the rays
  (random sphere scenes, seeds 7, 42, 1001), 5% (random meshes, seeds 3
  and 99, through every traversal) and 4% (the realtime config with smooth
  normals, through every traversal) may disagree.
- Smooth normals through ``pallas`` and ``pairs`` against ``dense``: fewer
  than 1% of pixels off by more than 1e-4 * |dense| + 2e-2.
- The port's primary rays are the oracle's cameras' (atol 2e-6).
"""
import dataclasses

import numpy as np
import pytest
import torch

from raytracinggpu_tpu.oracle import numpy_ref as jax_ref
from raytracinggpu_tpu_torch.core.rng import box_muller_terms
from raytracinggpu_tpu_torch.oracle import cases
from raytracinggpu_tpu_torch.render.pipeline import Camera, raygen
from raytracinggpu_tpu_torch.scene.scene import TRAVERSALS

torch.set_num_threads(2)

CASES = {
    **{f"spheres{s}": (lambda s=s: cases.sphere_case(s, "cpu"))
       for s in (7, 42, 1001)},
    **{f"mesh{s}": (lambda s=s: cases.mesh_case(s, "pallas", "cpu"))
       for s in (3, 99)},
    "realtime": lambda: cases.realtime_case("pallas", "cpu"),
}


@pytest.mark.parametrize("name", CASES)
def test_copy_is_the_jax_oracle(name, monkeypatch):
    port = CASES[name]()
    monkeypatch.setattr(cases, "OracleScene", jax_ref.OracleScene)
    jax = CASES[name]()
    assert type(port.oracle) is not type(jax.oracle)
    a, b = vars(port.oracle), vars(jax.oracle)
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], list):  # the triangles and normals
            for x, y in zip(a[k], b[k], strict=True):
                np.testing.assert_array_equal(x, y)
        else:
            np.testing.assert_array_equal(a[k], b[k])
    args = (port.O, port.u, port.uniforms, port.cfg.max_depth,
            port.cfg.eps_bounce, port.cfg.eps_leaf)
    ref = port.oracle.trace(*args)
    np.testing.assert_array_equal(ref, jax.oracle.trace(*args))
    assert np.isfinite(ref).all() and (ref > 0).any()


@pytest.mark.parametrize("seed", [7, 42, 1001])
def test_random_sphere_scene_matches_oracle(seed):
    case = cases.sphere_case(seed, "cpu")
    assert case.tables.mesh is None
    got, ref = cases.run(case)
    share = cases.disagree(got, ref)
    assert share < cases.SHARE["spheres"], f"{share:.2%} disagree"


@pytest.mark.parametrize("traversal", TRAVERSALS)
@pytest.mark.parametrize("seed", [3, 99])
def test_random_mesh_matches_oracle(seed, traversal):
    case = cases.mesh_case(seed, traversal, "cpu")
    got, ref = cases.run(case)
    share = cases.disagree(got, ref)
    assert share < cases.SHARE["mesh"], f"{share:.2%} disagree"


@pytest.mark.parametrize("traversal", TRAVERSALS)
def test_realtime_config_matches_oracle(traversal):
    case = cases.realtime_case(traversal, "cpu")
    assert case.cfg.smooth_normals and case.cfg.camera_point_quirk
    assert case.oracle.tri_normals is not None
    got, ref = cases.run(case)
    share = cases.disagree(got, ref)
    assert share < cases.SHARE["realtime"], (
        f"{share:.2%} rays disagree (smooth-normal path)")


@pytest.fixture(scope="module")
def smooth():
    return cases.smooth_frames("cpu")


@pytest.mark.parametrize("traversal", ["pallas", "pairs"])
def test_smooth_normals_match_dense(smooth, traversal):
    share = cases.smooth_disagree(smooth[traversal], smooth["dense"])
    assert share < cases.SMOOTH_SHARE, (
        f"{traversal}: {share:.2%} pixels disagree with the dense frame")
    assert np.isfinite(smooth[traversal]).all()


@pytest.mark.parametrize("preset", ["realtime", "global"])
def test_raygen_matches_the_oracle_camera(preset):
    W = H = 20
    if preset == "realtime":
        case = cases.realtime_case("pallas", "cpu", size=W)
    else:
        case = cases.sphere_case(7, "cpu", size=W)
    cfg = dataclasses.replace(case.cfg, sigma=0.0)
    zero = torch.zeros(W * H)
    O, u = raygen(cfg, Camera.default(cfg, "cpu"),
                  box_muller_terms(zero + 0.5, zero, 0.0),
                  np.arange(H, dtype=np.int32))
    np.testing.assert_allclose(torch.stack(tuple(u), -1).numpy(), case.u,
                               atol=2e-6)
    np.testing.assert_array_equal(torch.stack(tuple(O), -1).numpy(), case.O)
