"""The depth step's stages and the primary rays (ops/sphere.py,
integrator/wavefront.py, render/pipeline.py), whose kernels are
csrc/wavefront.cu's, through their plain versions on the CPU.

- ``sphere_hit_plain`` against the JAX package's ``intersect_spheres`` on
  the cat presets' walls and the showcase's ten spheres, with zero padding
  lanes: object ids agree on >= 99.9% of lanes, t and N to rtol 1e-5
  where they do (the JAX side rounds b*b - c and the dots with other
  fusions; an id flips only where two spheres' t round alike);
- ``primary_rays_plain``'s uniforms bitwise the JAX ``row_uniforms`` under
  the same key, sample and rows, its rays to rtol 1e-5 (atol 1e-6) of
  the JAX ``raygen`` fed the JAX package's own jitter, for the fixed and
  the quirk camera;
- ``trace`` built from ``shade_plain`` and ``bounce_plain`` against the
  JAX ``trace`` under ROADMAP.md's per-integrator-call standard:
  per-depth TraceStats within 0.5% of the lanes, radiance within rtol
  1e-3 on >= 99% of lanes (array_bvh pairs, realtime with smooth normals,
  showcase, array_bvh pallas with the JAX kernels in interpret mode);
- the refactor is exact: the new ``_depth_step`` and ``trace`` on CPU
  tensors equal, bit for bit, the copies of the parent's code kept here,
  on injected rays and uniforms, for every traversal;
- CPU tensors never reach ``ops/_kernels``, another device raises, and
  bench/depth_step.py's hard inputs, capture, plain-stage patching and
  record/replay run (on bench/_patch.patched, which puts every function
  back); its primary_rays bound counts the hashes the plain version
  makes and the keys it hashes under.

No test here imports a JAX bench module (ROADMAP C3).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core import rng as jrng
from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.integrator import wavefront as jwf
from raytracinggpu_tpu.ops.sphere import intersect_spheres as j_spheres
from raytracinggpu_tpu.render import pipeline as jp
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu_torch.bench import depth_step as ds
from raytracinggpu_tpu_torch.bench._patch import patched
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.core import rng as rng_mod
from raytracinggpu_tpu_torch.core.rays import RayBatch
from raytracinggpu_tpu_torch.core.rng import PRNGKey, cosine_hemisphere
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.core.vec import fma, sqrt, vgather, vwhere
from raytracinggpu_tpu_torch.integrator import wavefront as pwf
from raytracinggpu_tpu_torch.ops import _kernels
from raytracinggpu_tpu_torch.ops import sphere as psph
from raytracinggpu_tpu_torch.render import pipeline as pp
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.presets import build_preset

torch.set_num_threads(2)

R, D = 1024, 3


def _jv(a):
    return JV(*(jnp.asarray(c) for c in a))


def _pv(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(c)) for c in a))


@pytest.fixture(scope="module", params=["array_bvh", "showcase"])
def spheres(request):
    """(JAX scene, port scene) of the preset on the CPU."""
    jcfg, jtab = j_build_preset(request.param, width=32, height=32)
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jtab, ptab


def _sphere_rays(seed, n=4096):
    """(O, u) (3, n) f32: origins inside the box, a third of them at the
    camera aiming at the centre, the last eighth zero padding lanes."""
    rng = np.random.default_rng(seed)
    O = rng.uniform(-30, 30, (3, n)).astype(np.float32)
    O[:, : n // 3] = np.float32([[0.0], [0.0], [55.0]])
    d = rng.normal(size=(3, n))
    d[2, : n // 3] = -np.abs(d[2, : n // 3]) * 3.0
    u = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    O[:, n - n // 8:] = 0.0
    u[:, n - n // 8:] = 0.0
    return O, u


@pytest.mark.parametrize("seed", [0, 1])
def test_sphere_hit_plain_matches_jax(spheres, seed):
    jtab, ptab = spheres
    O, u = _sphere_rays(seed)
    tj, oj, Nj = jax.jit(j_spheres)(_jv(O), _jv(u), jtab.spheres)
    tp, op, Np = psph.sphere_hit_plain(_pv(O), _pv(u), ptab.spheres)
    oj, op = np.asarray(oj), op.numpy()
    assert op.dtype == np.int32
    same = oj == op
    assert same.mean() >= 0.999, same.mean()
    assert (op >= 0).mean() > 0.8 and (op[-len(op) // 8:] == -1).all()
    np.testing.assert_allclose(tp.numpy()[same], np.asarray(tj)[same],
                               rtol=1e-5)
    hit = same & (op >= 0)
    for a, b in zip(Nj, Np):
        np.testing.assert_allclose(b.numpy()[hit], np.asarray(a)[hit],
                                   rtol=1e-5, atol=1e-5)
    # the shadow mode's t is the closest mode's, bit for bit
    lv2 = torch.from_numpy(np.float32(np.random.default_rng(seed).uniform(
        0, 4000, len(op))))
    active = torch.from_numpy(np.arange(len(op)) % 3 > 0)
    ts, act = psph.sphere_shadow_plain(_pv(O), _pv(u), ptab.spheres, active,
                                       lv2)
    assert torch.equal(ts, tp)
    assert torch.equal(act, active & ~(tp * tp <= lv2))
    assert psph.sphere_shadow_plain(_pv(O), _pv(u), ptab.spheres)[1] is None


# ------------------------------------------------------- the primary rays

def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("preset,sample,rows", [
    ("array_bvh", 0, (0, 40)),
    ("array_bvh", 7, (13, 29)),
    ("realtime", 3, (0, 40)),
    ("realtime", 19, (31, 40)),
])
def test_primary_rays_plain_matches_jax(preset, sample, rows):
    jcfg, _ = j_build_preset(preset, width=40, height=40, max_depth=D)
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    r = np.arange(*rows, dtype=np.int32)
    key_j = jax.random.PRNGKey(5)
    un_j = jp.row_uniforms(jax.random.fold_in(key_j, sample), jnp.asarray(r),
                           jcfg.width, D)
    jcam = jp.Camera.default(jcfg)

    def jrays(un):
        gx, gy = jrng.box_muller_jitter(un[0, 0], un[0, 1],
                                        np.float32(jcfg.sigma))
        return jp.raygen(jcfg, jcam, gx, gy, r)

    Oj, uj = jax.jit(jrays)(un_j)
    pcam = pp.Camera.default(pcfg, "cpu")
    rows_t = torch.from_numpy(r.astype(np.int64))
    Op, up, un_p = pp.primary_rays_plain(pcfg, pcam, PRNGKey(5, "cpu"),
                                         sample, rows_t, r)
    assert tuple(un_p.shape) == (D, 2, len(r) * jcfg.width)
    np.testing.assert_array_equal(_bits(un_p.numpy()),
                                  _bits(np.asarray(un_j)[1:]))
    for a, b in zip(Oj, Op):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(uj, up):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    # primary_rays writes the same into a wavefront's buffers
    n = len(r) * jcfg.width
    O = torch.zeros(3, 2 * n)
    u = torch.zeros(3, 2 * n)
    un = torch.zeros(D, 2, 2 * n)
    pp.primary_rays(pcfg, pcam, PRNGKey(5, "cpu"), sample, rows_t, r,
                    PV(*O[:, n:]), PV(*u[:, n:]), un[..., n:])
    assert torch.equal(un[..., n:], un_p) and not un[..., :n].any()
    assert all(torch.equal(a[n:], b) for a, b in zip(u, up))
    assert all(torch.equal(a[n:], b) for a, b in zip(O, Op))


# ------------------------------------------------ trace against the JAX one

TRACES = {
    "array_bvh pairs": ("array_bvh", dict(traversal="pairs")),
    "realtime": ("realtime", dict(traversal="pairs")),
    "showcase": ("showcase", {}),
    "array_bvh pallas": ("array_bvh", dict(traversal="pallas")),
}


def _trace_rays(seed, camera_c):
    """Rays from the camera through random points of a 512-wide image
    plane, and (D, 2, R) uniforms in (0, 1]."""
    rng = np.random.default_rng(seed)
    px = rng.uniform(-200.0, 200.0, (2, R)).astype(np.float32)
    z = np.float32(-512.0 / (2.0 * np.tan(np.pi / 6.0)))
    d = np.stack([px[0], px[1], np.full(R, z, np.float32)])
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    O = np.tile(np.float32(camera_c)[:, None], (1, R))
    un = (1.0 - rng.random((D, 2, R))).astype(np.float32)
    return O, d.astype(np.float32), un


@pytest.mark.parametrize("case", list(TRACES))
def test_trace_of_the_plain_stages_matches_jax(case, monkeypatch):
    name, kw = TRACES[case]
    jcfg, jtab = j_build_preset(name, max_depth=D, **kw)
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    calls = {"shade_plain": 0, "bounce_plain": 0}
    for f in calls:
        orig = getattr(pwf, f)

        def counted(*a, _f=f, _orig=orig):
            calls[_f] += 1
            return _orig(*a)
        monkeypatch.setattr(pwf, f, counted)
    O, u, un = _trace_rays(11, (0.0, 0.0, 55.0))
    cj, sj = jax.jit(jwf.trace, static_argnums=1)(
        jtab, jcfg, _jv(O), _jv(u), jnp.asarray(un))
    cp, sp = pwf.trace(ptab, pcfg, _pv(O), _pv(u), torch.from_numpy(un))
    assert calls == {"shade_plain": D, "bounce_plain": D}
    for fname, a, b in zip(sj._fields, sj, sp):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape == (D,), fname
        assert (np.abs(a.astype(np.int64) - b) <= 0.005 * R).all(), (
            fname, a, b)
    a = np.stack([np.asarray(c) for c in cj])
    b = np.stack([c.numpy() for c in cp])
    assert np.isfinite(b).all()
    bad = (np.abs(a - b) > 1e-3 * np.abs(a)).any(axis=0)
    assert bad.mean() <= 0.01, bad.mean()
    assert (b != 0).any(axis=0).mean() > 0.5


# ------------------------------------------- the parent's code, for exactness

def _old_intersect_all(scene, cfg, O, u):
    t_s, obj_s, N_s = psph.sphere_hit_plain(O, u, scene.spheres)
    if scene.mesh is None:
        t, obj, N = t_s, obj_s, N_s
    else:
        traversal = pwf._effective_traversal(cfg, scene)
        if traversal == "pairs":
            mh, N_m = pwf.intersect_tris_pairs(
                O, u, scene.pairs_mesh, cfg.eps_leaf, cap=t_s,
                subg=cfg.pairs_subgroup, blk=cfg.pairs_block,
                payload="smooth" if cfg.smooth_normals else "geom",
                **pwf._ladder_args(cfg))
        elif traversal == "pallas":
            mh = pwf.intersect_tris_pallas(
                O, u, scene.pallas_mesh, cfg.eps_leaf,
                sort_rays=cfg.ray_sort, cap=t_s, subg=cfg.pallas_subgroup)
            N_m = (pwf._fused_smooth_recovery(scene, O, u, mh)
                   if cfg.smooth_normals
                   else pwf.geometric_normal(scene.mesh, mh))
        else:
            if traversal == "dense":
                mh = pwf.intersect_tris_dense(O, u, scene.mesh, cfg.eps_leaf,
                                              cfg.tri_block)
            else:  # bvh
                mh = pwf.intersect_tris_bvh(O, u, scene.mesh, scene.bvh,
                                            cfg.eps_leaf, cfg.bvh_max_leaf,
                                            cfg.bvh_node_layout)
            N_m = (pwf.smooth_normal if cfg.smooth_normals
                   else pwf.geometric_normal)(scene.mesh, mh)
        nn = N_m.norm()
        N_m = N_m / torch.where(nn > 0.0, nn, 1.0)

        use_mesh = mh.t < t_s
        t = torch.where(use_mesh, mh.t, t_s)
        obj = torch.where(use_mesh, cfg.mesh_object_id, obj_s)
        obj = torch.where(t < pwf.INF, obj, -1)
        N = vwhere(use_mesh, N_m, N_s)

    hit = obj >= 0
    t_safe = torch.where(hit, t, 0.0)
    P = u.fma(t_safe, O)
    return pwf.Hit(t=t, obj=obj, N=N, P=P)


def _old_occlusion_distance(scene, cfg, O, u, Lv, active=None):
    traversal = pwf._effective_traversal(cfg, scene)
    if scene.mesh is not None and traversal in ("dense", "bvh"):
        sh = _old_intersect_all(scene, cfg, O, u)
        return torch.where(sh.obj >= 0, sh.t, pwf.INF)
    t_sph, _, _ = psph.sphere_hit_plain(O, u, scene.spheres)
    if scene.mesh is None:
        return t_sph
    if traversal == "pallas":
        t_mesh = pwf.intersect_tris_shadow(
            O, u, scene.pallas_mesh, cfg.eps_leaf, cap=Lv.norm(),
            sort_rays=cfg.ray_sort, subg=cfg.pallas_subgroup)
        return torch.minimum(t_sph, t_mesh)
    if active is not None:
        active = active & ~(t_sph * t_sph <= Lv.norm2())
    t_mesh = pwf.intersect_tris_pairs_shadow(
        O, u, scene.pairs_mesh, cfg.eps_leaf, cap=Lv.norm(),
        subg=cfg.pairs_subgroup, blk=cfg.pairs_block, active=active,
        **pwf._ladder_args(cfg))
    return torch.minimum(t_sph, t_mesh)


def _old_depth_step(scene, cfg, ray, r1, r2):
    mats = scene.materials
    eps = float(np.float32(cfg.eps_bounce))
    O, u, ri = ray

    h = _old_intersect_all(scene, cfg, O, u)
    hit = h.obj >= 0
    oid = torch.clamp_min(h.obj, 0).long()
    N, P = h.N, h.P

    is_mirror = hit & mats.mirror[oid]
    in_ri_o = mats.in_ri[oid]
    out_ri_o = mats.out_ri[oid]
    is_refr = hit & (~mats.mirror[oid]) & (in_ri_o != out_ri_o)
    is_diff = hit & (~is_mirror) & (~is_refr)

    u_mir = (-N).fma(2.0 * u.dot(N), u)
    O_mir = N.fma(eps, P)

    out2in = ri == out_ri_o
    ratio = torch.where(out2in, out_ri_o / in_ri_o, in_ri_o / out_ri_o)
    N2 = vwhere(out2in, N, -N)
    cosi = u.dot(N2)
    sin2t = ratio * ratio * fma(-cosi, cosi, 1.0)
    denser_to_lighter = torch.where(out2in, ri > in_ri_o, ri > out_ri_o)
    is_tir = is_refr & denser_to_lighter & (sin2t > 1.0)
    u_tir = (-N2).fma(2.0 * cosi, u)
    O_tir = N2.fma(eps, P)
    u_ref = N2.fma(-sqrt(torch.clamp_min(1.0 - sin2t, 0.0)),
                   (-N2).fma(cosi, u) * ratio)
    O_ref = (-N2).fma(eps, P)
    ri_ref = torch.where(out2in, in_ri_o, out_ri_o)

    P_adj = N.fma(eps, P)
    Lv = scene.L - P_adj
    shadow_dir = Lv.normalized()
    LP = scene.L - P
    wl = LP.normalized()
    ndwl = N.dot(wl)
    sh_active = is_diff & (ndwl > 0.0)
    t_sh = _old_occlusion_distance(scene, cfg, P_adj, shadow_dir, Lv,
                                   active=sh_active)
    occluded = t_sh * t_sh <= Lv.norm2()

    lum = scene.intensity / (4.0 * pwf.PI * LP.norm2()) * torch.clamp_min(
        ndwl, 0.0)
    alb = vgather(mats.albedo, oid)
    lit = is_diff & (~occluded)
    direct = alb * torch.where(lit, lum / pwf.PI, 0.0)

    u_dif = cosine_hemisphere(r1, r2, N)

    not_tir = is_refr & ~is_tir
    O2 = vwhere(is_mirror, O_mir, O)
    u2 = vwhere(is_mirror, u_mir, u)
    O2 = vwhere(is_tir, O_tir, vwhere(not_tir, O_ref, O2))
    u2 = vwhere(is_tir, u_tir, vwhere(not_tir, u_ref, u2))
    ri2 = torch.where(not_tir, ri_ref, ri)
    O2 = vwhere(is_diff, P_adj, O2)
    u2 = vwhere(is_diff, u_dif, u2)
    ri2 = torch.where(is_diff, 1.0, ri2)

    counts = torch.stack([
        hit.sum(), is_mirror.sum(), is_refr.sum(), is_tir.sum(),
        is_diff.sum(), (sh_active & occluded).sum(),
    ])
    return RayBatch(O2, u2, ri2), is_diff, direct, alb, counts


def _old_trace(scene, cfg, O, u, uniforms):
    ray = RayBatch.make(O, u)
    steps = []
    for d, cfg_d in enumerate(pwf.depth_configs(scene, cfg,
                                                uniforms.shape[0])):
        ray, *out = _old_depth_step(scene, cfg_d, ray, uniforms[d, 0],
                                    uniforms[d, 1])
        steps.append(out)
    ans = PV.zeros(O.x.shape, device=O.x.device)
    for is_diff, direct, alb, _ in reversed(steps):
        ans = vwhere(is_diff, alb.fma(ans, direct), ans)
    counts = torch.stack([s[3] for s in steps])
    return ans, pwf.TraceStats(*counts.T)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        ds.bits(a), ds.bits(b))


EXACT = {
    "array_bvh pairs, ladder on": ("array_bvh", dict(
        traversal="pairs", pairs_block=128, pairs_compact=0.02,
        pairs_compact2=0.04, pairs_compact3=0.25)),
    "array_bvh pallas": ("array_bvh", dict(traversal="pallas")),
    "array_bvh dense": ("array_bvh", dict(traversal="dense")),
    "array_bvh bvh": ("array_bvh", dict(traversal="bvh")),
    "realtime smooth": ("realtime", {}),
    "showcase": ("showcase", {}),
}


@pytest.fixture(scope="module", params=list(EXACT))
def exact_scene(request):
    name, kw = EXACT[request.param]
    cfg, tab = build_preset(name, "cpu", width=32, height=32, max_depth=D,
                            **kw)
    return cfg, tab


def _inject(cfg, n=2048, seed=3):
    """Rays from the config's camera into the scene, rays from inside the
    box (some inside the showcase's glass), and uniforms with 1.0 and the
    smallest (0, 1] value among them."""
    rng = np.random.default_rng(seed)
    O, u, un = _trace_rays(seed, cfg.camera_c)
    O, u = O[:, :n // 2], u[:, :n // 2]
    O2 = rng.uniform(-20, 20, (3, n - n // 2)).astype(np.float32)
    O2[:, :64] = np.float32([[13.0], [0.0], [18.0]]) + rng.uniform(
        -4.7, 4.7, (3, 64)).astype(np.float32)
    d2 = rng.normal(size=(3, n - n // 2))
    u2 = (d2 / np.linalg.norm(d2, axis=0)).astype(np.float32)
    un = (1.0 - rng.random((D, 2, n))).astype(np.float32)
    un[:, :, :16] = 1.0
    un[:, :, 16:32] = np.float32(2.0**-24)
    return (np.concatenate([O, O2], 1), np.concatenate([u, u2], 1), un)


def test_depth_step_refactor_is_exact(exact_scene):
    """The new _depth_step (on CPU tensors: the plain stages) is bit for
    bit the parent's, rays, masks, terms and counts, at every depth."""
    cfg, tab = exact_scene
    O, u, un = _inject(cfg)
    ray_new = ray_old = RayBatch.make(_pv(O), _pv(u))
    un = torch.from_numpy(un)
    for d, cfg_d in enumerate(pwf.depth_configs(tab, cfg, D)):
        counts = torch.zeros(6, dtype=torch.int64)
        ray_new, is_diff, direct, alb = pwf._depth_step(
            tab, cfg_d, ray_new, un[d, 0], un[d, 1], counts)
        ray_old, is_diff_o, direct_o, alb_o, counts_o = _old_depth_step(
            tab, cfg_d, ray_old, un[d, 0], un[d, 1])
        for a, b in zip((*ray_new.O, *ray_new.u, ray_new.ri, is_diff,
                         *direct, *alb, counts),
                        (*ray_old.O, *ray_old.u, ray_old.ri, is_diff_o,
                         *direct_o, *alb_o, counts_o)):
            assert _same(a, b), d
    assert int(counts.sum()) > 0


def test_trace_refactor_is_exact(exact_scene):
    """The new trace (the composite of all three channels at once) is bit
    for bit the parent's, colours and TraceStats."""
    cfg, tab = exact_scene
    O, u, un = _inject(cfg, seed=4)
    col, st = pwf.trace(tab, cfg, _pv(O), _pv(u), torch.from_numpy(un))
    col_o, st_o = _old_trace(tab, cfg, _pv(O), _pv(u), torch.from_numpy(un))
    assert all(_same(a, b) for a, b in zip(col, col_o))
    assert all(_same(a, b) for a, b in zip(st, st_o))
    if cfg.name == "showcase":
        assert int(st.tir.sum()) > 0 and int(st.mirror.sum()) > 0


# ------------------------------------------------------ dispatch on the CPU

@pytest.mark.parametrize("preset", ["array_bvh", "showcase", "realtime"])
def test_cpu_tensors_never_reach_the_kernels(preset, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU tensor reached ops/_kernels")

    cfg, tab = build_preset(preset, "cpu", width=16, height=12, spp=2,
                            max_depth=2)
    want = render_preset_frame(tab, cfg, seed=0)
    for name in _kernels.DEPTH_STEP:
        monkeypatch.setattr(_kernels, name, refuse)
    before = dict(_kernels.LAUNCHES)
    img, st = render_preset_frame(tab, cfg, seed=0)
    assert _kernels.LAUNCHES == before
    np.testing.assert_array_equal(img, want[0])
    assert int(st.hit.sum()) == 2 * 16 * 12 * 2


def test_other_devices_raise():
    x = torch.zeros(4, device="meta")
    v = PV(x, x, x)
    cfg, tab = build_preset("showcase", "cpu", width=4, height=1)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        psph.intersect_spheres(v, v, tab.spheres)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        psph.sphere_shadow(v, v, tab.spheres)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pwf.shade(tab, cfg, RayBatch(v, v, x), None, None, None)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pwf.bounce(None, x, None, x, x, None)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        pp.primary_rays(cfg, None, None, 0, torch.zeros(1, dtype=torch.int64,
                                                        device="meta"),
                        np.zeros(1), v, v, x)


# ----------------------------------------- bench/depth_step.py on the CPU

@pytest.fixture(scope="module")
def small_scenes():
    return {name: build_preset(name, "cpu", width=24, height=16, spp=2,
                               max_depth=2)
            for name in ("array_bvh", "showcase")}


def test_capture_keeps_each_stages_first_calls(small_scenes):
    cfg, tab = small_scenes["array_bvh"]
    kept, (img, _) = ds.capture(lambda: render_preset_frame(tab, cfg, 0))
    assert {k: [(label, kind) for label, kind, _ in v]
            for k, v in kept.items()} == {
        "sphere_hit": [("depth 0", "closest"), ("depth 0", "shadow"),
                       ("depth 1", "closest"), ("depth 1", "shadow")],
        "shade": [("depth 0", "shade"), ("depth 1", "shade")],
        "bounce": [("depth 0", "bounce"), ("depth 1", "bounce")],
        "primary_rays": [("sample 0", "primary_rays"),
                         ("sample 1", "primary_rays")]}
    # the dispatchers are put back, and each kept call reruns to the same
    # bits through the plain version
    assert pwf.shade.__name__ == "shade"
    for kernel, calls in kept.items():
        for label, kind, args in calls:
            a = ds.run(kernel, kind, args, plain=True)
            assert ds.same_bits(a, ds.run(kernel, kind, args, plain=True))
            bound, by = ds.call_bound(kernel, kind, args, a)
            assert bound > 0 and by in ("bytes", "operations")
    with ds.plain_stages():
        assert pwf.shade is pwf.shade_plain
        img2, _ = render_preset_frame(tab, cfg, 0)
    assert pwf.shade is not pwf.shade_plain
    np.testing.assert_array_equal(img, img2)


@pytest.mark.parametrize("preset", ["array_bvh", "showcase"])
def test_adversarial_calls_run_through_the_plain_versions(small_scenes,
                                                          preset):
    cfg, tab = small_scenes[preset]
    calls = ds.adversarial_calls(tab, cfg, R=2048)
    assert [c[0] for c in calls].count("primary_rays") == 3
    for kernel, label, kind, args in calls:
        out = ds.run(kernel, kind, args, plain=True)
        assert out and all(o.shape[-1] >= 1 for o in out), label
        if kernel == "shade" and preset == "showcase":
            assert out[-1][3] > 0  # lanes of total internal reflection
        if kernel == "sphere_hit" and kind == "closest":
            t = out[0]
            assert torch.isnan(out[2]).any() or torch.isinf(t).any() \
                or (t >= 1e9).any()
    assert ds.max_abs_err([torch.tensor([1.0, math.nan])],
                          [torch.tensor([1.5, math.nan])]) == 0.5
    assert ds.max_abs_err([torch.tensor([math.nan])],
                          [torch.tensor([0.0])]) == math.inf


def test_primary_rays_bound_counts_the_plain_versions_hashes(small_scenes):
    """call_work's integer operations of a primary_rays call are
    THREEFRY_OPS a hash the plain version makes and THREEFRY_KEY_OPS a
    key it hashes under (its frame key, the sample's, each row's)."""
    cfg, tab = small_scenes["array_bvh"]
    kept, _ = ds.capture(lambda: render_preset_frame(tab, cfg, 0))
    args = kept["primary_rays"][1][2]
    hashes, keys = [0], set()
    hash_ = rng_mod.threefry2x32

    def counting(k0, k1, x0, x1):
        y0, y1 = hash_(k0, k1, x0, x1)
        hashes[0] += y0.numel()
        keys.update(zip(torch.broadcast_to(k0, y0.shape).flatten().tolist(),
                        torch.broadcast_to(k1, y0.shape).flatten().tolist()))
        return y0, y1

    with patched({("core.rng", "threefry2x32"): lambda _: counting}):
        outs = ds.flatten(pp.primary_rays_plain(*args))
    R = args[4].shape[0] * cfg.width
    assert hashes[0] == R * 2 * (cfg.max_depth + 1) + args[4].shape[0] + 1
    _, ops = ds.call_work("primary_rays", "primary_rays", args, outs)
    assert ops["int32"] == (hashes[0] * ds.THREEFRY_OPS
                            + len(keys) * ds.THREEFRY_KEY_OPS)


def test_patched_puts_every_function_back_on_an_error():
    before = (pwf.shade, pp.primary_rays)
    with pytest.raises(RuntimeError):
        with patched({("integrator.wavefront", "shade"): lambda f: None,
                      ("render.pipeline", "primary_rays"): lambda f: f}):
            assert pwf.shade is None and pp.primary_rays is before[1]
            raise RuntimeError("inside")
    assert (pwf.shade, pp.primary_rays) == before


def test_record_replay_gives_back_a_frames_mesh_casts(small_scenes):
    """Replayed, the mesh casts do not run (a cast that ran would raise)
    and the frame is the recorded one."""
    cfg, tab = small_scenes["array_bvh"]
    record, replay = ds.record_replay(ds.MESH_CASTS)
    with record():
        want, _ = render_preset_frame(tab, cfg, 0)
    with replay(), patched({("ops.pairs_trace", "_pair_bits"):
                            lambda f: None}):
        got, _ = render_preset_frame(tab, cfg, 0)
    np.testing.assert_array_equal(got, want)
