"""The port's wavefront integrator against the JAX package's
(raytracinggpu_tpu_torch/integrator/wavefront.py).

Both packages trace the same injected rays with the same injected
uniforms on identical tables (``scene_tables_from_numpy``), the JAX pairs
kernel in Pallas interpret mode as the JAX package's own tests run it.
The mesh casts differ in their last bits (XLA:CPU contracts the kernel's
multiply-adds into FMAs, the port rounds every product; see
tests/test_torch_pairs.py), and a path whose shadow ray grazes an edge
flips.  So the standard is statistical:

- per-depth TraceStats within 0.5% of the lane count;
- radiance within rtol 1e-3 on >= 99% of lanes.

Measured on these inputs: at most one shadowed lane of 2048 differs per
depth, and 2 lanes of 2048 fall outside rtol 1e-3 (one flipped shadow
decision each).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.integrator import wavefront as jwf
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.integrator import wavefront as pwf

torch.set_num_threads(2)

R, D = 2048, 3


@pytest.fixture(scope="module")
def scene():
    jcfg, jtab = j_build_preset("array_bvh", traversal="pairs", max_depth=D)
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    return jcfg, jtab, pcfg, ptab


def _camera_rays(seed):
    """(O, u) (3, R) f32: rays from the default camera through random
    points of the 512x512 image plane, and (D, 2, R) uniforms in (0, 1]."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-256.0, 256.0, (2, R)).astype(np.float32)
    z = np.float32(-512.0 / (2.0 * np.tan(np.pi / 6.0)))
    d = np.stack([px[0], px[1], np.full(R, z, np.float32)])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, R))
    un = (1.0 - rng.random((D, 2, R))).astype(np.float32)
    return O, d.astype(np.float32), un


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _pv(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@pytest.mark.parametrize("seed", [0, 1])
def test_trace_matches_jax(scene, seed):
    jcfg, jtab, pcfg, ptab = scene
    O, u, un = _camera_rays(seed)
    cj, sj = jax.jit(jwf.trace, static_argnums=1)(
        jtab, jcfg, _jv(O), _jv(u), jnp.asarray(un))
    cp, sp = pwf.trace(ptab, pcfg, _pv(O), _pv(u), torch.from_numpy(un))
    for name, a, b in zip(sj._fields, sj, sp):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (D,), name
        assert (np.abs(a.astype(np.int64) - b) <= 0.005 * R).all(), (name, a, b)
    assert (sp.hit.numpy() == R).all()  # the scene is enclosed
    assert (sp.shadowed.numpy() > 0).all()  # the cat casts a shadow
    a = np.stack([np.asarray(c) for c in cj])
    b = np.stack([c.numpy() for c in cp])
    assert np.isfinite(b).all()
    bad = (np.abs(a - b) > 1e-3 * np.abs(a)).any(axis=0)
    assert bad.mean() <= 0.01, bad.mean()
    assert (b != 0).any(axis=0).mean() > 0.9  # most paths carry light


def test_intersect_all_matches_jax(scene):
    """The sphere + mesh merge: object ids agree on >= 99.9% of lanes, t
    and the unit normal to rtol 1e-5 where the ids agree."""
    jcfg, jtab, pcfg, ptab = scene
    O, u, _ = _camera_rays(2)
    hj = jax.jit(jwf.intersect_all, static_argnums=1)(
        jtab, jcfg, _jv(O), _jv(u))
    hp = pwf.intersect_all(ptab, pcfg, _pv(O), _pv(u))
    oj, op = np.asarray(hj.obj), hp.obj.numpy()
    assert op.dtype == np.int32
    same = oj == op
    assert same.mean() >= 0.999, same.mean()
    assert (op == pcfg.mesh_object_id).sum() > 50  # the cat is hit
    assert (op >= 0).all()
    np.testing.assert_allclose(hp.t.numpy()[same], np.asarray(hj.t)[same],
                               rtol=1e-5)
    for a, b in zip(hj.N, hp.N):
        np.testing.assert_allclose(b.numpy()[same], np.asarray(a)[same],
                                   rtol=1e-5, atol=1e-5)


def test_occlusion_distance_matches_jax(scene):
    """Shadow rays from the primary hits toward the light: the occlusion
    predicate t^2 <= |L-P|^2 (t the nearer of the port's two shadow
    distances) agrees on >= 99.9% of the active lanes, and
    a lane a sphere occludes stays occluded though it leaves the mesh
    query's active set."""
    jcfg, jtab, pcfg, ptab = scene
    O, u, _ = _camera_rays(3)
    hp = pwf.intersect_all(ptab, pcfg, _pv(O), _pv(u))
    P = hp.N.fma(1e-4, hp.P)
    Lv = ptab.L - P
    d = Lv.normalized()
    active = hp.obj >= 0
    t_sph, t_mesh = pwf._shadow_distances(ptab, pcfg, P, d, Lv.norm(),
                                          Lv.norm2(), active)
    tp = t_sph if t_mesh is None else torch.minimum(t_sph, t_mesh)
    tj = jax.jit(jwf.occlusion_distance, static_argnums=1)(
        jtab, jcfg, _jv([c.numpy() for c in P]), _jv([c.numpy() for c in d]),
        _jv([c.numpy() for c in Lv]), active=jnp.asarray(active.numpy()))
    L2 = Lv.norm2().numpy()
    occ_p = tp.numpy() ** 2 <= L2
    occ_j = np.asarray(tj) ** 2 <= L2
    act = active.numpy()
    assert (occ_p[act] == occ_j[act]).mean() >= 0.999
    assert occ_p[act].sum() > 10  # the cat shadows some of the floor
    t_sph = pwf.intersect_spheres(P, d, ptab.spheres)[0].numpy()
    assert occ_p[t_sph ** 2 <= L2].all()


def test_unported_modes_raise(scene):
    """Every mode of a JAX config now enters the port: the ``bvh``
    traversal with its layout and leaf bound, the animated mesh and the
    clustering knobs, once refused here, convert field for field; a
    traversal neither package has is still refused."""
    jcfg = scene[0]
    over = dict(traversal="bvh", animate_mesh=True, bvh_node_layout="aos10",
                bvh_max_leaf=12, pairs_cluster="sah", pairs_pack="pave",
                pairs_cut=32)
    got = render_config_from_dict(
        dataclasses.asdict(dataclasses.replace(jcfg, **over)))
    assert {k: getattr(got, k) for k in over} == over
    assert dataclasses.replace(scene[2], traversal="bvh").traversal == "bvh"
    with pytest.raises(ValueError):
        dataclasses.replace(scene[2], traversal="tiles")
    # the realtime modes and the pallas and dense traversals are ported
    smooth = dataclasses.replace(jcfg, smooth_normals=True,
                                 camera_point_quirk=True)
    assert render_config_from_dict(dataclasses.asdict(smooth)).smooth_normals
    for traversal in ("pallas", "dense"):
        d = dataclasses.asdict(dataclasses.replace(jcfg, traversal=traversal))
        assert render_config_from_dict(d).traversal == traversal
