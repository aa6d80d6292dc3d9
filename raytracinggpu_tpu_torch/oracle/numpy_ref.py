"""NumPy oracle renderer (the port's own copy of
``raytracinggpu_tpu/oracle/numpy_ref.py``, numpy only: an oracle, not a
path of the port).

An *independent* CPU implementation of the reference algorithm
(cpu_launcher.cpp:566-648 / global_launcher.cu:738-839) used as the golden
model for differential tests:

- classic Moller-Trumbore (cross products per pair) instead of the port's
  feature-row algebra (``csrc/mt.cuh`` and its plain versions),
- naive all-triangles intersection (no BVH) so acceleration-structure bugs
  cannot cancel out,
- same uniforms injected, so images must match the port's integrator to
  float tolerance, not just Monte-Carlo tolerance.

It follows the GPU-canonical iterative depth convention: ``max_depth``
iterations of the depth loop (getColorIterative runs exactly ``num_bounce``
iterations, global_launcher.cu:743).  (The CPU recursive version counts one
extra level; the framework standardizes on the GPU convention.)
"""
from __future__ import annotations

import numpy as np

INF = 1e9 + 9


class OracleScene:
    """Plain-python scene: spheres + optional triangle soup."""

    def __init__(self, spheres, materials, L, intensity, tris=None, mesh_mat=None,
                 tri_normals=None):
        # spheres: list of (center(3,), radius); materials: list of
        # (albedo(3,), mirror, in_ri, out_ri) — mesh material appended last.
        # tri_normals: optional (Na, Nb, Nc) per-corner vertex normals for
        # Phong-smooth shading (realtime_render.cu:221-245).
        self.C = np.array([s[0] for s in spheres], np.float32)
        self.R = np.array([s[1] for s in spheres], np.float32)
        mats = list(materials)
        self.tris = None
        self.tri_normals = None
        if tris is not None:
            self.tris = [np.asarray(t, np.float32) for t in tris]  # (A, B, C)
            if tri_normals is not None:
                self.tri_normals = [np.asarray(t, np.float32) for t in tri_normals]
            mats.append(mesh_mat)
        self.albedo = np.array([m[0] for m in mats], np.float32)
        self.mirror = np.array([m[1] for m in mats], bool)
        self.in_ri = np.array([m[2] for m in mats], np.float32)
        self.out_ri = np.array([m[3] for m in mats], np.float32)
        self.L = np.asarray(L, np.float32)
        self.intensity = np.float32(intensity)

    # -- geometry ------------------------------------------------------
    def intersect_spheres(self, O, u):
        """(R,3) rays -> per-sphere min merge; reference Sphere::intersect."""
        oc = O[:, None, :] - self.C[None, :, :]          # (R, S, 3)
        b = np.einsum("rd,rsd->rs", u, oc)               # u.(O-C)
        delta = b * b - ((oc * oc).sum(-1) - self.R[None, :] ** 2)
        sq = np.sqrt(np.maximum(delta, 0.0))
        t1, t2 = -b - sq, -b + sq
        t = np.where(t1 < 0.0, t2, t1)
        t = np.where((delta >= 0.0) & (t2 >= 0.0), t, INF)
        j = np.argmin(t, axis=1)
        tmin = t[np.arange(len(t)), j]
        obj = np.where(tmin < INF, j, -1).astype(np.int32)
        P = O + u * np.where(tmin < INF, tmin, 0.0)[:, None]
        cw = self.C[np.maximum(j, 0)]
        n = P - cw
        nn = np.linalg.norm(n, axis=-1, keepdims=True)
        N = n / np.where(nn > 0, nn, 1.0)
        return tmin, obj, N

    def intersect_mesh(self, O, u, eps_leaf):
        """Naive Moller-Trumbore over every triangle (classic formulation,
        global_launcher.cu:233-243), float32 like the reference."""
        A, B, C = self.tris
        e1 = B - A                                        # (T, 3)
        e2 = C - A
        Ng = np.cross(e1, e2)
        ao = A[None, :, :] - O[:, None, :]                # (R, T, 3) = A - O
        denom = np.einsum("rd,td->rt", u, Ng)             # u.N
        aoxu = np.cross(ao, u[:, None, :])                # (A-O) x u
        with np.errstate(invalid="ignore", divide="ignore"):
            beta = np.einsum("td,rtd->rt", e2, aoxu) / denom
            gamma = -np.einsum("td,rtd->rt", e1, aoxu) / denom
            t = np.einsum("rtd,td->rt", ao, Ng) / denom
        with np.errstate(invalid="ignore"):
            valid = (
                (denom != 0.0)
                & (beta >= 0) & (beta <= 1)
                & (gamma >= 0) & (gamma <= 1)
                & (beta + gamma <= 1)
                & (t > 0)
                & (t > eps_leaf)
            )
        t = np.where(valid, t, INF)
        j = np.argmin(t, axis=1)
        rows = np.arange(len(t))
        tmin = t[rows, j]
        if self.tri_normals is not None:
            # Phong interpolation at the winning triangle
            # (get_smooth_normal, realtime_render.cu:221-245).
            b = beta[rows, j]
            g = gamma[rows, j]
            a = 1.0 - b - g
            Na, Nb, Nc = self.tri_normals
            n = (a[:, None] * Na[j] + b[:, None] * Nb[j] + g[:, None] * Nc[j])
        else:
            n = Ng[j]
        nn = np.linalg.norm(n, axis=-1, keepdims=True)
        N = n / np.where(nn > 0, nn, 1.0)
        return tmin, N

    def intersect_all(self, O, u, eps_leaf):
        t, obj, N = self.intersect_spheres(O, u)
        if self.tris is not None:
            tm, Nm = self.intersect_mesh(O, u, eps_leaf)
            use_mesh = tm < t
            t = np.where(use_mesh, tm, t)
            obj = np.where(use_mesh, len(self.C), obj).astype(np.int32)
            N = np.where(use_mesh[:, None], Nm, N)
        P = O + u * np.where(t < INF, t, 0.0)[:, None]
        return t, obj, N, P

    # -- integrator ----------------------------------------------------
    def trace(self, O, u, uniforms, max_depth, eps_bounce, eps_leaf):
        """Iterative integrator with injected uniforms (D, 2, R)."""
        Rn = len(O)
        ri = np.ones(Rn, np.float32)
        types = np.zeros((max_depth, Rn), bool)
        directs = np.zeros((max_depth, Rn, 3), np.float32)
        albedos = np.zeros((max_depth, Rn, 3), np.float32)
        O = O.astype(np.float32).copy()
        u = u.astype(np.float32).copy()

        for d in range(max_depth):
            t, obj, N, P = self.intersect_all(O, u, eps_leaf)
            hit = obj >= 0
            oid = np.maximum(obj, 0)
            mir = hit & self.mirror[oid]
            iri, ori = self.in_ri[oid], self.out_ri[oid]
            refr = hit & ~self.mirror[oid] & (iri != ori)
            diff = hit & ~mir & ~refr

            udN = (u * N).sum(-1)
            # mirror
            O_m = P + eps_bounce * N
            u_m = u - 2 * udN[:, None] * N
            # refraction
            out2in = ri == ori
            ratio = np.where(out2in, ori / iri, iri / ori)
            N2 = np.where(out2in[:, None], N, -N)
            cosi = (u * N2).sum(-1)
            sin2t = ratio**2 * (1 - cosi**2)
            denser = np.where(out2in, ri > iri, ri > ori)
            tir = refr & denser & (sin2t > 1)
            O_t = P + eps_bounce * N2
            u_t = u - 2 * cosi[:, None] * N2
            O_r = P - eps_bounce * N2
            u_r = (
                -np.sqrt(np.maximum(1 - sin2t, 0.0))[:, None] * N2
                + ratio[:, None] * (u - cosi[:, None] * N2)
            )
            ri_r = np.where(out2in, iri, ori)
            # diffuse
            P_adj = P + eps_bounce * N
            Lv = self.L[None, :] - P_adj
            sd = Lv / np.linalg.norm(Lv, axis=-1, keepdims=True)
            t_s, obj_s, _, _ = self.intersect_all(P_adj, sd, eps_leaf)
            occ = t_s * t_s <= (Lv * Lv).sum(-1)
            LP = self.L[None, :] - P
            wl = LP / np.linalg.norm(LP, axis=-1, keepdims=True)
            lum = (
                self.intensity
                / (4 * np.pi * (LP * LP).sum(-1))
                * np.maximum((N * wl).sum(-1), 0.0)
            )
            alb = self.albedo[oid]
            lit = diff & ~occ
            directs[d] = alb * np.where(lit, lum / np.float32(np.pi), 0.0)[:, None]
            albedos[d] = alb
            types[d] = diff
            r1, r2 = uniforms[d, 0], uniforms[d, 1]
            x = np.cos(2 * np.pi * r1) * np.sqrt(1 - r2)
            y = np.sin(2 * np.pi * r1) * np.sqrt(1 - r2)
            z = np.sqrt(r2)
            cond = (np.abs(N[:, 1]) != 0) & (np.abs(N[:, 0]) != 0)
            T1 = np.where(
                cond[:, None],
                np.stack([-N[:, 1], N[:, 0], np.zeros(Rn, np.float32)], -1),
                np.stack([-N[:, 2], np.zeros(Rn, np.float32), N[:, 0]], -1),
            )
            T1 = T1 / np.linalg.norm(T1, axis=-1, keepdims=True)
            T2 = np.cross(N, T1)
            u_d = x[:, None] * T1 + y[:, None] * T2 + z[:, None] * N

            # merge
            sel = lambda m, a, b: np.where(m[:, None], a, b)
            O2, u2, ri2 = O.copy(), u.copy(), ri.copy()
            O2 = sel(mir, O_m, O2); u2 = sel(mir, u_m, u2)
            O2 = sel(refr & ~tir, O_r, O2); u2 = sel(refr & ~tir, u_r, u2)
            O2 = sel(tir, O_t, O2); u2 = sel(tir, u_t, u2)
            ri2 = np.where(refr & ~tir, ri_r, ri2)
            O2 = sel(diff, P_adj, O2); u2 = sel(diff, u_d, u2)
            ri2 = np.where(diff, 1.0, ri2).astype(np.float32)
            O, u, ri = O2.astype(np.float32), u2.astype(np.float32), ri2

        ans = np.zeros((Rn, 3), np.float32)
        for d in reversed(range(max_depth)):
            ans = np.where(types[d][:, None], albedos[d] * ans + directs[d], ans)
        return ans

    def render(self, W, H, fov, cam_c, spp, max_depth, sigma,
               eps_bounce, eps_leaf, jitters, uniforms):
        """Full frame with injected randomness.

        jitters: (spp, 2, R); uniforms: (spp, D, 2, R).
        """
        x = np.arange(W, dtype=np.float32)
        y = np.arange(H, dtype=np.float32)
        ux = np.tile(x - W / 2 + 0.5, H)
        uy = np.repeat(H / 2 - y - 0.5, W)
        z = np.float32(-W / (2 * np.tan(fov / 2)))
        acc = np.zeros((W * H, 3), np.float32)
        for s in range(spp):
            r1, r2 = jitters[s, 0], jitters[s, 1]
            mag = sigma * np.sqrt(-2 * np.log(r1))
            gx = mag * np.cos(2 * np.pi * r2)
            gy = mag * np.sin(2 * np.pi * r2)
            d = np.stack([ux + gx, uy + gy, np.full(W * H, z, np.float32)], -1)
            u = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
            O = np.tile(np.asarray(cam_c, np.float32), (W * H, 1))
            acc += self.trace(O, u, uniforms[s], max_depth, eps_bounce, eps_leaf)
        return (acc / spp).reshape(H, W, 3)
