"""Wavefront path-tracing integrator (port of
``raytracinggpu_tpu/integrator/wavefront.py``: the pairs, pallas, dense and
bvh traversals, with geometric or smooth mesh normals).

The whole ray batch advances in lockstep through a Python loop over depth;
material branches are masks merged with ``torch.where``, and the per-depth
stacks feed a backward composite with the reference's recurrence

    ans = indirect_albedo[i] * ans + direct_color[i]   (only where diffuse)

Material semantics (same formulas, same epsilons):

- mirror:   u' = u - 2(u.N)N, origin offset +eps*N
- refract:  Snell with medium tracking via the ray's refraction index, N
            flipped when exiting, total internal reflection; the TIR ray
            keeps its medium, the transmitted ray takes the entered one's
- diffuse:  shadow ray toward the point light, occluded iff the shadow
            hit's squared distance <= |L-P_adj|^2; direct =
            intensity/(4 pi |L-P|^2) * max(N.w,0) * albedo/pi; a
            cosine-weighted bounce that RESETS the medium to 1.0
- miss:     the lane's ray is left unchanged

A depth (``_depth_step``) runs the sphere pass, the mesh's closest cast,
the shading (``shade``: the merge, the materials, the shadow ray), the
shadow rays' sphere pass and mesh cast, and the bounce (``bounce``: the
occlusion, the direct term, the diffuse direction); ``trace`` then runs
the backward composite (``composite``).  For CUDA tensors the sphere
passes, ``shade`` and ``bounce`` launch the kernels of
``csrc/wavefront.cu`` and ``composite`` the kernel ``rt_composite`` of
``csrc/glue.cu``; for CPU tensors their plain versions run
(``ops/sphere.sphere_hit_plain``, ``shade_plain``, ``bounce_plain``,
``composite_plain``).  The mesh casts are the traversal's own.

The pairs traversal's casts run the compaction ladder of
``ops/pairs_trace.py`` as the config's ``pairs_compact*`` fields set it,
per depth as ``depth_configs`` says; the frame is the same with it off.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.device import on_cuda
from raytracinggpu_tpu_torch.core.rays import RayBatch
from raytracinggpu_tpu_torch.core.rng import cosine_hemisphere
from raytracinggpu_tpu_torch.core.vec import Vec3, fma, sqrt, vgather, vwhere
from raytracinggpu_tpu_torch.ops.bvh_traverse import intersect_tris_bvh
from raytracinggpu_tpu_torch.ops.pairs_trace import (
    intersect_tris_pairs,
    intersect_tris_pairs_shadow,
)
from raytracinggpu_tpu_torch.ops.pallas_trace import (
    barycentrics_from_rows,
    intersect_tris_pallas,
    intersect_tris_shadow,
)
from raytracinggpu_tpu_torch.ops.sphere import (
    INF,
    intersect_spheres,
    sphere_shadow,
)
from raytracinggpu_tpu_torch.ops.triangle import (
    geometric_normal,
    intersect_tris_dense,
    phong,
    smooth_normal,
)
from raytracinggpu_tpu_torch.scene.scene import RenderConfig, SceneTables
from raytracinggpu_tpu_torch.utils.profiling import span

PI = float(np.float32(np.pi))


class Hit(NamedTuple):
    t: torch.Tensor    # (R,), INF on miss
    obj: torch.Tensor  # (R,) int32 object id, -1 on miss
    N: Vec3            # unit normal (masked lanes arbitrary)
    P: Vec3            # hit point O + t*u (masked lanes arbitrary)


def _effective_traversal(cfg: RenderConfig, scene: SceneTables) -> str:
    """'pairs' runs as 'pallas' when the scene has a mesh but no pairs
    tables (the pairs build refused the mesh, here or in the JAX package
    whose tables were converted); mesh-less
    scenes keep their configured traversal (no mesh query runs)."""
    if (cfg.traversal == "pairs" and scene.mesh is not None
            and scene.pairs_mesh is None):
        return "pallas"
    return cfg.traversal


def _fused_smooth_recovery(scene: SceneTables, O: Vec3, u: Vec3, mh):
    """The winner's Phong normal (unnormalized) from ONE (R, 25) row gather
    of [fieldsT, cornersT[:, :9]]: the barycentrics from the MT field row,
    then alpha*na + beta*nb + gamma*nc from the vertex normals."""
    rec = torch.cat([scene.pallas_mesh.fieldsT, scene.mesh.cornersT[:, :9]],
                    dim=1)
    rows = rec[mh.idx.long()]
    beta, gamma = barycentrics_from_rows(O, u, lambda k: rows[:, k])
    return phong(rows, 1.0 - beta - gamma, beta, gamma, col=16)


def _ladder_args(cfg: RenderConfig) -> dict:
    """The pairs queries' compaction-ladder arguments from the config."""
    return dict(compact=cfg.pairs_compact, compact2=cfg.pairs_compact2,
                compact3=cfg.pairs_compact3, key_coarse=cfg.pairs_key_coarse)


def depth_configs(scene: SceneTables, cfg: RenderConfig,
                  depth: int) -> list[RenderConfig]:
    """The config of each depth of ``trace``: the JAX package's per-depth
    ladder policy of its unrolled depth loop, which the Python loop here
    always is, at its defaults.  When ``pairs_compact_min_depth`` > 0 and
    the pairs traversal runs a mesh with ``pairs_compact`` set, the depths
    below it run with every tier at 0 (full width, no key); else every
    depth runs ``cfg``.  (The JAX package's ``pairs_compact_d0`` and
    ``pairs_subgroup_d0``, a tier and a subgroup of those depths' own,
    are TPU knobs the port leaves out: at their default, 0, the policy is
    this one.)"""
    mind = int(cfg.pairs_compact_min_depth)
    if not (mind > 0 and cfg.pairs_compact and scene.mesh is not None
            and _effective_traversal(cfg, scene) == "pairs"):
        return [cfg] * depth
    cfg0 = dataclasses.replace(cfg, pairs_compact=0.0, pairs_compact2=0.0,
                               pairs_compact3=0.0)
    return [cfg0 if d < mind else cfg for d in range(depth)]


def _mesh_closest(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3,
                  t_s):
    """The mesh's closest cast, capped by the nearest sphere hit ``t_s``
    where the traversal culls: (t, N) with N the winner's unnormalized
    normal (geometric, or the realtime preset's Phong-interpolated vertex
    normal) in contiguous rows, or None when the scene has no mesh."""
    if scene.mesh is None:
        return None
    with span("cast.closest"):
        traversal = _effective_traversal(cfg, scene)
        if traversal == "pairs":
            # the kernel tracks the winner's normal
            mh, N_m = intersect_tris_pairs(
                O, u, scene.pairs_mesh, cfg.eps_leaf, cap=t_s,
                subg=cfg.pairs_subgroup, blk=cfg.pairs_block,
                payload="smooth" if cfg.smooth_normals else "geom",
                **_ladder_args(cfg))
        elif traversal == "pallas":
            mh = intersect_tris_pallas(
                O, u, scene.pallas_mesh, cfg.eps_leaf,
                sort_rays=cfg.ray_sort, cap=t_s, subg=cfg.pallas_subgroup)
            N_m = (_fused_smooth_recovery(scene, O, u, mh)
                   if cfg.smooth_normals
                   else geometric_normal(scene.mesh, mh))
        else:
            if traversal == "dense":
                mh = intersect_tris_dense(O, u, scene.mesh, cfg.eps_leaf,
                                          cfg.tri_block)
            else:  # bvh
                mh = intersect_tris_bvh(O, u, scene.mesh, scene.bvh,
                                        cfg.eps_leaf, cfg.bvh_max_leaf,
                                        cfg.bvh_node_layout)
            # both give the winner's barycentrics
            N_m = (smooth_normal if cfg.smooth_normals
                   else geometric_normal)(scene.mesh, mh)
        return mh.t, Vec3(*(c.contiguous() for c in N_m))


def _merge(cfg: RenderConfig, O: Vec3, u: Vec3, sph, mesh) -> Hit:
    """The nearer of the sphere hit ``sph`` = (t, obj, N) and the mesh's
    closest cast ``mesh`` (see ``_mesh_closest``; None without a mesh).
    The mesh holds the highest object id and the reference scans ids
    ascending with a strict `<`, so the mesh wins only strictly."""
    t_s, obj_s, N_s = sph
    if mesh is None:
        t, obj, N = t_s, obj_s, N_s
    else:
        t_m, N_m = mesh
        nn = N_m.norm()
        N_m = N_m / torch.where(nn > 0.0, nn, 1.0)

        use_mesh = t_m < t_s
        t = torch.where(use_mesh, t_m, t_s)
        obj = torch.where(use_mesh, cfg.mesh_object_id, obj_s)
        obj = torch.where(t < INF, obj, -1)
        N = vwhere(use_mesh, N_m, N_s)

    hit = obj >= 0
    t_safe = torch.where(hit, t, 0.0)  # avoid inf*0 NaN on miss lanes
    P = u.fma(t_safe, O)
    return Hit(t=t, obj=obj, N=N, P=P)


def intersect_all(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3) -> Hit:
    """Scene-wide nearest hit: the sphere pass plus the mesh pass merged by
    min-t (``_merge``).  The depth step merges inside ``shade``; this query
    serves the dense and bvh traversals' shadow rays and callers outside
    the integrator."""
    sph = intersect_spheres(O, u, scene.spheres)
    return _merge(cfg, O, u, sph, _mesh_closest(scene, cfg, O, u, sph[0]))


def _mesh_shadow(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3,
                 cap, active):
    """The mesh's shadow cast (pairs or pallas): its nearest hit distance,
    tiles past ``cap`` (the distance to the light) culled; the pairs
    traversal skips the lanes ``active`` leaves out."""
    with span("cast.shadow"):
        if _effective_traversal(cfg, scene) == "pallas":
            return intersect_tris_shadow(
                O, u, scene.pallas_mesh, cfg.eps_leaf, cap=cap,
                sort_rays=cfg.ray_sort, subg=cfg.pallas_subgroup)
        return intersect_tris_pairs_shadow(
            O, u, scene.pairs_mesh, cfg.eps_leaf, cap=cap,
            subg=cfg.pairs_subgroup, blk=cfg.pairs_block, active=active,
            **_ladder_args(cfg))


def _shadow_distances(scene: SceneTables, cfg: RenderConfig, O: Vec3,
                      u: Vec3, cap, lv2, active=None):
    """The shadow rays' (t_sph, t_mesh), whose minimum is the distance that
    occlusion compares with the light's |L - P_adj|^2 = ``lv2`` (``cap`` =
    |L - P_adj|).  The pairs and pallas traversals run their shadow kernels
    with ``cap``; dense and bvh reuse the full closest hit, as in the JAX
    package, and give it as t_sph with t_mesh None (as a scene without a
    mesh does).

    active: (R,) bool — lanes whose occlusion result is provably unused
    (non-diffuse, missed, or N.wl <= 0).  The pairs traversal skips their
    mesh work, and that of lanes a sphere already occludes: min(t_sph,
    t_mesh) can only shrink, so the predicate is unchanged.  Inactive lanes
    may return the sphere-only distance."""
    traversal = _effective_traversal(cfg, scene)
    if scene.mesh is not None and traversal in ("dense", "bvh"):
        sh = intersect_all(scene, cfg, O, u)
        return torch.where(sh.obj >= 0, sh.t, INF), None
    if scene.mesh is None or traversal != "pairs":
        active = None
    t_sph, active = sphere_shadow(O, u, scene.spheres, active,
                                  None if active is None else lv2)
    if scene.mesh is None:
        return t_sph, None
    return t_sph, _mesh_shadow(scene, cfg, O, u, cap, active)


class TraceStats(NamedTuple):
    """Per-depth lane counts, (D,) int64 tensors."""

    hit: torch.Tensor
    mirror: torch.Tensor
    refract: torch.Tensor
    tir: torch.Tensor
    diffuse: torch.Tensor
    shadowed: torch.Tensor


class Shade(NamedTuple):
    """What the shading of a depth (``shade``) hands to the shadow casts
    and the bounce; every field (R,) but ``alb``."""

    O2: Vec3        # the next ray: origin, direction (the bounce replaces
    u2: Vec3        # the diffuse lanes'), medium; misses keep their ray
    ri2: torch.Tensor
    S: Vec3         # the shadow ray: origin P_adj, unit direction to the
    d: Vec3         # light, |L - P_adj| (the mesh cast's cap) and its square
    cap: torch.Tensor
    lv2: torch.Tensor
    N: Vec3         # the unit normal at the hit
    alb: torch.Tensor  # (3, R) the hit object's albedo
    lum: torch.Tensor  # the light's term over pi, before occlusion
    is_diff: torch.Tensor  # diffuse hits
    sh_active: torch.Tensor  # diffuse hits lit from the front: the lanes
    #                          whose shadow query counts


def shade_plain(scene: SceneTables, cfg: RenderConfig, ray: RayBatch, sph,
                mesh, counts) -> Shade:
    """The merge of the sphere hit ``sph`` (t, obj, N) and the mesh's
    closest cast ``mesh`` (``_mesh_closest``), the materials, mirror,
    refraction with total internal reflection, and the diffuse lanes'
    shadow ray and light term, in PyTorch ops (the contract of the kernel
    ``rt_shade``); adds the hit, mirror, refract, tir and diffuse lanes
    into counts[:5]."""
    mats = scene.materials
    eps = float(np.float32(cfg.eps_bounce))
    O, u, ri = ray

    h = _merge(cfg, O, u, sph, mesh)
    hit = h.obj >= 0
    oid = torch.clamp_min(h.obj, 0).long()  # lanes masked by `hit`
    N, P = h.N, h.P

    is_mirror = hit & mats.mirror[oid]
    in_ri_o = mats.in_ri[oid]
    out_ri_o = mats.out_ri[oid]
    is_refr = hit & (~mats.mirror[oid]) & (in_ri_o != out_ri_o)
    is_diff = hit & (~is_mirror) & (~is_refr)

    # ---- mirror ----
    u_mir = (-N).fma(2.0 * u.dot(N), u)
    O_mir = N.fma(eps, P)

    # ---- refraction ----
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

    # ---- diffuse ----
    P_adj = N.fma(eps, P)
    Lv = scene.L - P_adj
    shadow_dir = Lv.normalized()
    LP = scene.L - P
    wl = LP.normalized()
    ndwl = N.dot(wl)
    # shadow work is provably unused where the lane is not diffuse or the
    # light is behind the surface (the direct term is exactly zero)
    sh_active = is_diff & (ndwl > 0.0)
    lum = scene.intensity / (4.0 * PI * LP.norm2()) * torch.clamp_min(ndwl, 0.0)
    alb = vgather(mats.albedo, oid)

    # ---- merge next-ray state; misses keep their ray unchanged ----
    not_tir = is_refr & ~is_tir
    O2 = vwhere(is_mirror, O_mir, O)
    u2 = vwhere(is_mirror, u_mir, u)
    O2 = vwhere(is_tir, O_tir, vwhere(not_tir, O_ref, O2))
    u2 = vwhere(is_tir, u_tir, vwhere(not_tir, u_ref, u2))
    ri2 = torch.where(not_tir, ri_ref, ri)
    O2 = vwhere(is_diff, P_adj, O2)
    ri2 = torch.where(is_diff, 1.0, ri2)  # bounce rays reset the medium

    counts[:5] += torch.stack([hit.sum(), is_mirror.sum(), is_refr.sum(),
                               is_tir.sum(), is_diff.sum()])
    return Shade(O2, u2, ri2, P_adj, shadow_dir, Lv.norm(), Lv.norm2(), N,
                 torch.stack(tuple(alb)), lum / PI, is_diff, sh_active)


def bounce_plain(sh: Shade, t_sph, t_mesh, r1, r2, counts):
    """Occlusion, the direct term and the diffuse lanes' cosine-weighted
    bounce, in PyTorch ops (the contract of the kernel ``rt_bounce``):
    (the next direction u3, direct (3, R)); the shadow distance is
    min(t_sph, t_mesh), or t_sph when t_mesh is None; adds the shadowed
    lanes (counted only where the shadow query is meaningful) into
    counts[5]."""
    t_sh = t_sph if t_mesh is None else torch.minimum(t_sph, t_mesh)
    occluded = t_sh * t_sh <= sh.lv2
    lit = sh.is_diff & (~occluded)
    direct = sh.alb * torch.where(lit, sh.lum, 0.0)
    u_dif = cosine_hemisphere(r1, r2, sh.N)
    counts[5] += (sh.sh_active & occluded).sum()
    return vwhere(sh.is_diff, u_dif, sh.u2), direct


def shade(scene: SceneTables, cfg: RenderConfig, ray: RayBatch, sph, mesh,
          counts) -> Shade:
    """``shade_plain`` on the rays' device: the kernel ``rt_shade`` for CUDA
    tensors, the plain version for CPU tensors."""
    with span("shade"):
        if not on_cuda(ray.u.x):
            return shade_plain(scene, cfg, ray, sph, mesh, counts)
        from raytracinggpu_tpu_torch.ops import _kernels

        m = scene.materials
        O2, u2, ri2, S, d, cap, lv2, N, alb, lum, is_diff, sh_active = \
            _kernels.shade(ray.O, ray.u, ray.ri, sph, mesh,
                           (m.albedo, m.mirror, m.in_ri, m.out_ri), scene.L,
                           scene.intensity, float(np.float32(cfg.eps_bounce)),
                           cfg.mesh_object_id, counts)
        return Shade(Vec3(*O2), Vec3(*u2), ri2, Vec3(*S), Vec3(*d), cap, lv2,
                     Vec3(*N), alb, lum, is_diff, sh_active)


def bounce(sh: Shade, t_sph, t_mesh, r1, r2, counts):
    """``bounce_plain`` on the rays' device: the kernel ``rt_bounce`` for
    CUDA tensors, the plain version for CPU tensors."""
    with span("bounce"):
        if not on_cuda(r1):
            return bounce_plain(sh, t_sph, t_mesh, r1, r2, counts)
        from raytracinggpu_tpu_torch.ops import _kernels

        u3, direct = _kernels.bounce(sh.u2, sh.N, sh.alb, sh.lum, sh.lv2,
                                     sh.is_diff, sh.sh_active, t_sph, t_mesh,
                                     r1, r2, counts)
        return Vec3(*u3), direct


def _depth_step(scene: SceneTables, cfg: RenderConfig, ray: RayBatch, r1, r2,
                counts):
    """One bounce of the whole batch: the sphere pass, the mesh's closest
    cast, the shading, the shadow rays' sphere pass and mesh cast, the
    bounce.  Returns (next RayBatch, is_diff, direct (3, R), albedo
    (3, R)) and adds the depth's six counts into ``counts`` (6,)."""
    O, u, _ = ray
    sph = intersect_spheres(O, u, scene.spheres)
    mesh = _mesh_closest(scene, cfg, O, u, sph[0])
    sh = shade(scene, cfg, ray, sph, mesh, counts)
    t_sph, t_mesh = _shadow_distances(scene, cfg, sh.S, sh.d, sh.cap,
                                      sh.lv2, active=sh.sh_active)
    u3, direct = bounce(sh, t_sph, t_mesh, r1, r2, counts)
    return RayBatch(sh.O2, u3, sh.ri2), sh.is_diff, direct, sh.alb


def composite_plain(steps, R: int, device) -> torch.Tensor:
    """The backward composite of the depth steps [(is_diff (R,), direct
    (3, R), albedo (3, R)), ...], the three channels at once, in PyTorch
    ops (the contract of the kernel ``rt_composite``): (3, R) f32, ans = 0,
    then from the last depth to the first ans = fma(albedo, ans, direct)
    where the lane was diffuse."""
    ans = torch.zeros((3, R), dtype=torch.float32, device=device)
    for is_diff, direct, alb in reversed(steps):
        ans = torch.where(is_diff, fma(alb, ans, direct), ans)
    return ans


def composite(steps, R: int, device) -> torch.Tensor:
    """``composite_plain`` on the steps' device: the kernel ``rt_composite``
    of ``csrc/glue.cu`` for CUDA tensors, one launch for up to eight
    depths, the plain version for CPU tensors.  A trace of no depth
    composes nothing: its (zero) result is the plain version's."""
    with span("composite"):
        if not steps or not on_cuda(steps[0][0]):
            return composite_plain(steps, R, device)
        from raytracinggpu_tpu_torch.ops import _kernels

        return _kernels.composite(steps)


def trace(scene: SceneTables, cfg: RenderConfig, O: Vec3, u: Vec3,
          uniforms: torch.Tensor) -> tuple[Vec3, TraceStats]:
    """Path-trace a ray batch to its final color.

    O, u: primary rays, components (R,).  uniforms: (max_depth, 2, R) U(0,1]
    — the two per-depth uniforms of the diffuse bounce, drawn outside so a
    test can inject identical numbers.  Returns (color Vec3 (R,),
    TraceStats)."""
    with span("trace"):
        ray = RayBatch.make(O, u)  # primary rays start in medium 1.0
        D, dev = uniforms.shape[0], O.x.device
        counts = torch.zeros((D, 6), dtype=torch.int64, device=dev)
        steps = []
        for d, cfg_d in enumerate(depth_configs(scene, cfg, D)):
            with span("depth", d):
                ray, *out = _depth_step(scene, cfg_d, ray, uniforms[d, 0],
                                        uniforms[d, 1], counts[d])
            steps.append(out)

        ans = composite(steps, O.x.shape[0], dev)
        return Vec3(*ans), TraceStats(*counts.T)
