"""The presets ``cpu``, ``global``, ``optimized`` and ``showcase`` of the
port against the JAX package (raytracinggpu_tpu_torch/scene/presets.py).

- Every table array of each preset is bitwise the JAX package's (the
  build functions are the same numpy code), and ``scene_tables_from_numpy``
  carries a mesh-less table (``showcase``) across.
- The 48x48, spp 2, depth 2, seed 0 frames are held against the stored
  goldens (``tests/golden/<preset>_48.npy``, rendered by the JAX package
  with the dense traversal) under ``tests/test_golden.py``'s bound: fewer
  than 0.5% of pixels off by more than 1e-4*|g| + 1.0.
- ``showcase`` is the only preset with mirror and refractive spheres: an
  injected-uniform ``trace`` toward them against the JAX integrator, under
  the standard of tests/test_torch_integrator.py (per-depth TraceStats
  within 0.5% of the lane count, radiance within rtol 1e-3 on >= 99% of
  lanes), with lanes counted in the mirror, refraction and total internal
  reflection branches.
- The ``cpu`` preset's room is not quite closed: every lane of its 512x512
  spp 8 depth 5 frame that loses a ray on the card loses the same rays in
  both packages on the CPU.
"""
import dataclasses
import json
import os

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
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.presets import (
    _MESH_TRANSFORM,
    PRESET_NAMES,
    build_preset,
)

torch.set_num_threads(2)

NEW = ("cpu", "global", "optimized", "showcase")
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
SIZE = dict(width=48, height=48, spp=2, max_depth=2)
R, D = 4096, 4


@pytest.fixture(scope="module", params=NEW)
def both(request):
    name = request.param
    jcfg, jtab = j_build_preset(name, traversal="pairs", **SIZE)
    pcfg, ptab = build_preset(name, "cpu", **SIZE)
    return name, jcfg, jax.tree.map(np.asarray, jtab), pcfg, ptab


def _same(a, b):
    a, b = np.atleast_1d(np.asarray(a)), np.atleast_1d(np.asarray(b))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype,
                                                       b.shape, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _leaves(tab):
    """Every tensor leaf of a port SceneTables, in field order."""
    out = []
    for part in tab:
        if part is None:
            continue
        items = part if isinstance(part, tuple) else (part,)
        for x in items:
            if isinstance(x, tuple):
                out.extend(x)
            elif isinstance(x, torch.Tensor):
                out.append(x)
    return out


def test_tables_bitwise(both):
    name, jcfg, jtab, pcfg, ptab = both
    assert render_config_from_dict(dataclasses.asdict(jcfg)) == pcfg
    assert pcfg.n_objects == jcfg.n_objects == (10 if name == "showcase"
                                                 else 7)
    for f in ("cx", "cy", "cz", "radius"):
        _same(getattr(ptab.spheres, f).numpy(), getattr(jtab.spheres, f))
    for c in range(3):
        _same(ptab.materials.albedo[c].numpy(), jtab.materials.albedo[c])
        _same(ptab.L[c].numpy(), jtab.L[c])
    for f in ("mirror", "in_ri", "out_ri"):
        _same(getattr(ptab.materials, f).numpy(), getattr(jtab.materials, f))
    _same(ptab.intensity.numpy(), jtab.intensity)
    if name == "showcase":
        assert ptab.mesh is ptab.pallas_mesh is ptab.pairs_mesh is None
        assert jtab.mesh is None and pcfg.mesh_object_id == -1
        assert ptab.spheres.radius.shape == (10,)
        assert ptab.materials.mirror.tolist() == [False] * 7 + [True, False,
                                                                False]
        return
    for f in ptab.pairs_mesh._fields:
        _same(getattr(ptab.pairs_mesh, f).numpy(),
              getattr(jtab.pairs_mesh, f))
    for f in ("fields", "fieldsT", "tile_aabb"):
        _same(getattr(ptab.pallas_mesh, f).numpy(),
              getattr(jtab.pallas_mesh, f))
    _same(ptab.mesh.mt.numpy(), jtab.mesh.mt)
    assert ptab.pairs_mesh.tile_aabb.shape[0] == 40
    assert pcfg.pairs_subgroup == 64


def test_convert_carries_the_tables_across(both):
    _, _, jtab, _, ptab = both
    conv = scene_tables_from_numpy(jtab, "cpu")
    a, b = _leaves(conv), _leaves(ptab)
    assert len(a) == len(b) > 10
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (conv.mesh is None) == (ptab.mesh is None)


def test_frame_matches_golden(both):
    name, _, _, pcfg, ptab = both
    img, stats = render_preset_frame(ptab, pcfg, seed=0)
    assert img.shape == (48, 48, 3) and np.isfinite(img).all()
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}_48.npy"))
    bad = np.abs(img - golden) > 1e-4 * np.abs(golden) + 1.0
    assert bad.any(-1).mean() < 0.005
    n = 48 * 48 * 2
    assert stats.hit.tolist() == [n, n]  # every scene is enclosed
    if name == "showcase":
        assert int(stats.mirror.sum()) > 0 and int(stats.refract.sum()) > 0
    else:
        assert int(stats.mirror.sum()) == int(stats.refract.sum()) == 0
        assert int(stats.shadowed.sum()) > 0  # the cat casts a shadow


def test_mesh_transforms_are_the_jax_packages():
    from raytracinggpu_tpu.scene.presets import _MESH_TRANSFORM as J

    assert _MESH_TRANSFORM == J
    assert set(_MESH_TRANSFORM) == set(PRESET_NAMES) - {"showcase"}


def test_showcase_takes_no_mesh():
    from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh
    from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH

    mesh = load_cat_mesh(CAT_OBJ_PATH, *_MESH_TRANSFORM["array_bvh"])
    with pytest.raises(ValueError, match="showcase"):
        build_preset("showcase", "cpu", mesh=mesh)


# ---------------------------------------------- showcase: every branch

@pytest.fixture(scope="module")
def showcase():
    jcfg, jtab = j_build_preset("showcase", traversal="pairs", max_depth=D)
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jcfg, jtab, render_config_from_dict(dataclasses.asdict(jcfg)), ptab


def _rays_at_the_spheres(seed):
    """(O, u) (3, R) f32 from the default camera toward the band that
    holds the three showcase spheres (x in [-18, 18], y in [-5, 5] at
    z = 18), and (D, 2, R) uniforms in (0, 1]."""
    rng = np.random.default_rng(seed)
    tx = rng.uniform(-18.0, 18.0, R)
    ty = rng.uniform(-5.0, 5.0, R)
    d = np.stack([tx, ty, np.full(R, 18.0 - 55.0)]).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = np.tile(np.float32([[0.0], [0.0], [55.0]]), (1, R))
    un = (1.0 - rng.random((D, 2, R))).astype(np.float32)
    return O, d.astype(np.float32), un


@pytest.mark.parametrize("seed", [0, 1])
def test_showcase_trace_matches_jax(showcase, seed):
    jcfg, jtab, pcfg, ptab = showcase
    O, u, un = _rays_at_the_spheres(seed)
    jv = lambda a: JV(*(jnp.asarray(c) for c in a))
    pv = lambda a: PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))
    cj, sj = jax.jit(jwf.trace, static_argnums=1)(
        jtab, jcfg, jv(O), jv(u), jnp.asarray(un))
    cp, sp = pwf.trace(ptab, pcfg, pv(O), pv(u), torch.from_numpy(un))
    for name, a, b in zip(sj._fields, sj, sp):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (D,), name
        assert (np.abs(a.astype(np.int64) - b) <= 0.005 * R).all(), (name,
                                                                      a, b)
    assert (sp.hit.numpy() == R).all()  # the scene is enclosed
    # every material branch runs: the mirror sphere, the glass shell and
    # its bubble, and total internal reflection inside the glass
    assert int(sp.mirror.sum()) > 100
    assert int(sp.refract.sum()) > 100
    assert int(sp.tir.sum()) > 0
    assert int(sp.diffuse.sum()) > 100
    a = np.stack([np.asarray(c) for c in cj])
    b = np.stack([c.numpy() for c in cp])
    assert np.isfinite(b).all()
    bad = (np.abs(a - b) > 1e-3 * np.abs(a)).any(axis=0)
    assert bad.mean() <= 0.01, bad.mean()


# ------------------------------------- cpu: the rays that leave the room

@pytest.fixture(scope="module")
def lost_rays():
    """The recorded lanes of the ``cpu`` preset's 512x512 spp 8 depth 5
    seed 0 frame that lose a ray (tests/golden/cpu_512_lost_rays.json,
    found on the card), each rendered alone through both packages:
    (record, [(JAX hits per depth, port hits per depth), ...] with one
    row that loses nothing at the end).  Both render the mesh through the
    dense traversal, and the port the second lane also through the pairs
    plain versions, which stand for the kernels the card runs."""
    from raytracinggpu_tpu.render import pipeline as jpipe
    from raytracinggpu_tpu_torch.core.rng import PRNGKey
    from raytracinggpu_tpu_torch.render import pipeline as ppipe

    with open(os.path.join(GOLDEN_DIR, "cpu_512_lost_rays.json")) as f:
        rec = json.load(f)
    size = {k: rec["frame"][k] for k in ("width", "height", "spp",
                                         "max_depth")}
    jcfg, jtab = j_build_preset("cpu", traversal="dense", **size)
    pcfg, ptab = build_preset("cpu", "cpu", traversal="dense", **size)
    jrows = jax.jit(jpipe.render_rows, static_argnums=(1,))
    jcam, pcam = jpipe.Camera.default(jcfg), ppipe.Camera.default(pcfg, "cpu")
    seed = rec["frame"]["seed"]
    hits = []
    for row, s, _ in rec["lanes"] + [[256, 0, None]]:
        rows = np.array([row], np.int32)
        js = jrows(jtab, jcfg, jcam, jax.random.PRNGKey(seed), rows,
                   np.array([s]))[1]
        ps = ppipe.render_rows(ptab, pcfg, pcam, PRNGKey(seed, "cpu"), rows,
                               [s])[1]
        hits.append((np.asarray(js.hit).tolist(), ps.hit.tolist()))
    row, s, _ = rec["lanes"][1]
    pairs = ppipe.render_rows(
        ptab, dataclasses.replace(pcfg, traversal="pairs"), pcam,
        PRNGKey(seed, "cpu"), np.array([row], np.int32), [s])[1].hit.tolist()
    return rec, hits, pairs


def test_cpu_preset_loses_the_rays_the_jax_package_loses(lost_rays):
    """Where rays escape the ``cpu`` preset's room, both packages lose the
    same number at every depth of every lane."""
    rec, hits, pairs = lost_rays
    assert pairs == hits[1][1] and sum(pairs) < 5 * rec["frame"]["width"]
    W = rec["frame"]["width"]
    for (row, s, lost), (jh, ph) in zip(rec["lanes"], hits):
        assert jh == ph == [W - n for n in lost], (row, s, jh, ph)
        assert sum(lost) > 0
    assert hits[-1] == ([W] * 5, [W] * 5)  # a row in the middle: closed
    n = W * rec["frame"]["height"] * rec["frame"]["spp"]
    assert rec["hits_per_depth"] == [
        n - sum(lane[2][d] for lane in rec["lanes"]) for d in range(5)]
    assert rec["hits_per_depth"][-1] == n - 26
