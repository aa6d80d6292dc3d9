"""The benchmark's plain reference renderer: PyTorch tensor operations and
NumPy only, written for the benchmark and importing nothing of the
program.  It renders the rows of a frame that the check asks for from the
same seed and the same OBJ file the program is given, and works out again
everything the program derives from them: the uniforms (a frozen copy of
the threefry2x32 keying of ``raytracinggpu_tpu_torch/core/rng.py`` and
``render/pipeline.row_uniforms``, a4aff6f), the camera rays, the light's
orbit, and every hit against the raw triangles of the OBJ, with the
classic Moller-Trumbore test of ``raytracinggpu_tpu_torch/oracle/
numpy_ref.py`` (a4aff6f) and that oracle's integrator.

It rounds as the upstream CUDA renderer's compiler rounds: each a*b + c
fused into one rounding (``_fma``), square roots, cosines and sines
correctly rounded, the logarithm of the camera's jitter the fused Cephes
logf.  Whether a shadow ray leaving a wall re-hits it hangs on those last
bits, and so does every path after it.

To keep the brute-force mesh query affordable at the timed sizes the
triangles are split, by median cuts of their centroids, into groups of at
most ``GROUP`` whose boxes, padded by ``BOX_PAD``, cull whole groups for a
ray; a culled group holds no triangle the ray can hit, so the result is
the all-triangles query's (``test_bench_reference`` holds the two equal).

``dtype`` is the precision the whole computation runs in: float32, the
configuration's, or a lower one for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

INF = 1e9 + 9
PI = float(np.float32(np.pi))
MASK = 0xFFFFFFFF
GROUP = 64        # triangles a culling group holds at most
BOX_PAD = 1e-3    # scene units a group box is widened by on every side
RAY_BLOCK = 1 << 16   # rays a mesh query tests at once
PAIR_BLOCK = 1 << 17  # (ray, group) pairs a Moller-Trumbore block holds
RAYS_PER_TRACE = 1 << 20  # rays of the samples traced together


# ---------------------------------------------------------------- the RNG

def _rotl(v, d):
    return ((v << d) | (v >> (32 - d))) & MASK


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on uint32 words held in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    for i in range(5):
        for r in rot[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def seed_key(seed: int, device):
    """The key of an integer seed: words (seed >> 32, seed & 0xFFFFFFFF)."""
    w = lambda v: torch.tensor(v & MASK, dtype=torch.int64, device=device)
    return w(seed >> 32), w(seed)


def fold_in(key, data):
    """Hash the counter (0, data) under ``key``; a tensor ``data`` gives a
    batch of keys."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key[0].device) & MASK
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def row_uniforms(key_s, rows, W: int, depth: int):
    """Uniforms in (0, 1] of sample key ``key_s`` for the global ``rows``:
    (depth+1, 2, nr, W) float32; slot 0 the pixel jitter's pair, slots
    1..depth each depth's bounce pair.  Row y hashes counter i of the
    (depth+1, 2, W) array under fold_in(key_s, y), the two words xor-ed,
    and the top 23 bits make a float in [1, 2)."""
    k0, k1 = fold_in(key_s, rows)
    n = (depth + 1) * 2 * W
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], i >> 32, i & MASK)
    bits = (y0 ^ y1) >> 9 | 0x3F800000
    u = bits.to(torch.int32).view(torch.float32) - 1.0
    return (1.0 - u).reshape(-1, depth + 1, 2, W).permute(1, 2, 0, 3)


# ---------------------------------------------------------------- the scene

def read_obj_triangles(path: str):
    """The OBJ's triangles (fan-triangulated faces) as corner arrays
    (A, B, C) and, where every corner has a normal, the per-corner normals
    (Na, Nb, Nc) or None; float32 numpy (T, 3) each."""
    verts, norms, faces = [], [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                nv, nn = len(verts), len(norms)
                corners = []
                for c in tok[1:]:
                    p = c.split("/")
                    v = int(p[0])
                    n = int(p[2]) if len(p) > 2 and p[2] else None
                    corners.append((v - 1 if v > 0 else nv + v,
                                    None if n is None else
                                    (n - 1 if n > 0 else nn + n)))
                for k in range(1, len(corners) - 1):
                    faces.append((corners[0], corners[k], corners[k + 1]))
    V = np.asarray(verts, np.float32)
    tri = lambda j: V[[f[j][0] for f in faces]]
    A, B, C = tri(0), tri(1), tri(2)
    normals = None
    if norms and all(c[1] is not None for f in faces for c in f):
        Nv = np.asarray(norms, np.float32)
        normals = tuple(Nv[[f[j][1] for f in faces]] for j in range(3))
    return (A, B, C), normals


def _groups(A, B, C, size: int):
    """Median cuts of the triangle centroids along the widest axis down to
    groups of at most ``size``: (index table (G, size), -1 padded)."""
    cen = (A + B + C) / 3.0
    out, todo = [], [np.arange(A.shape[0])]
    while todo:
        ids = todo.pop()
        if len(ids) <= size:
            out.append(ids)
            continue
        c = cen[ids]
        ax = int(np.argmax(c.max(0) - c.min(0)))
        order = ids[np.argsort(c[:, ax], kind="stable")]
        half = len(order) // 2
        todo += [order[:half], order[half:]]
    tab = np.full((len(out), size), -1, np.int64)
    for g, ids in enumerate(out):
        tab[g, :len(ids)] = np.sort(ids)
    return tab


@dataclass
class Scene:
    """The reference's scene on one device in one precision."""

    sc: torch.Tensor      # (S, 3) sphere centres
    sr: torch.Tensor      # (S,) radii
    albedo: torch.Tensor  # (M, 3), the mesh's material last
    mirror: torch.Tensor  # (M,) bool
    in_ri: torch.Tensor
    out_ri: torch.Tensor
    L0: np.ndarray        # (3,) f32 light position before any orbit
    intensity: float
    eps_bounce: float
    eps_leaf: float
    tris: tuple | None    # (A, B, C) (T+1, 3), a null triangle last
    normals: tuple | None  # (Na, Nb, Nc) (T+1, 3) for smooth shading
    gtab: torch.Tensor | None  # (G, GROUP) triangle ids, T on padding
    gbox: torch.Tensor | None  # (G, 6) padded group boxes
    mbox: torch.Tensor | None  # (6,) padded box of the whole mesh
    n_tri: int
    dtype: torch.dtype


def build_scene(scene_cfg: dict, obj_path: str | None, device,
                dtype=torch.float32) -> Scene:
    """The scene of a configuration's ``scene`` entry (spheres, materials,
    light, epsilons, the mesh's transform and material), the mesh read
    from ``obj_path``."""
    t = lambda a, dt=dtype: torch.as_tensor(np.asarray(a), device=device
                                            ).to(dt)
    sph = scene_cfg["spheres"]
    mats = list(scene_cfg["materials"])
    mesh = scene_cfg.get("mesh")
    tris = normals = gtab = gbox = mbox = None
    T = 0
    if mesh is not None:
        (A, B, C), nrm = read_obj_triangles(obj_path)
        s = np.float32(mesh["scale"])
        off = np.asarray(mesh["offset"], np.float32)
        A, B, C = ((v * s + off).astype(np.float32) for v in (A, B, C))
        tab = _groups(A, B, C, GROUP)
        T = A.shape[0]
        lo = np.minimum(np.minimum(A, B), C)
        hi = np.maximum(np.maximum(A, B), C)
        valid = tab >= 0
        idx = np.where(valid, tab, 0)
        glo = np.where(valid[..., None], lo[idx], np.inf).min(1) - BOX_PAD
        ghi = np.where(valid[..., None], hi[idx], -np.inf).max(1) + BOX_PAD
        pad = lambda v: np.concatenate([v, np.zeros((1, 3), np.float32)])
        tris = tuple(t(pad(v)) for v in (A, B, C))
        if mesh.get("smooth_normals") and nrm is not None:
            normals = tuple(t(pad(v)) for v in nrm)
        gtab = torch.as_tensor(np.where(valid, tab, T), device=device)
        gbox = torch.as_tensor(np.concatenate([glo, ghi], 1),
                               dtype=torch.float32, device=device)
        mbox = torch.as_tensor(np.concatenate([lo.min(0) - BOX_PAD,
                                               hi.max(0) + BOX_PAD]),
                               dtype=torch.float32, device=device)
        mats.append(mesh["material"])
    return Scene(
        sc=t([s_[0] for s_ in sph]), sr=t([s_[1] for s_ in sph]),
        albedo=t([m[0] for m in mats]),
        mirror=torch.as_tensor([bool(m[1]) for m in mats], device=device),
        in_ri=t([m[2] for m in mats]), out_ri=t([m[3] for m in mats]),
        L0=np.asarray(scene_cfg["light"], np.float32),
        intensity=float(scene_cfg["intensity"]),
        eps_bounce=float(np.float32(scene_cfg["eps_bounce"])),
        eps_leaf=float(np.float32(scene_cfg["eps_leaf"])),
        tris=tris, normals=normals, gtab=gtab, gbox=gbox, mbox=mbox,
        n_tri=T, dtype=dtype)


def orbit_light(L0: np.ndarray, frame: int, speed: float, dt: float):
    """The light on its orbit about the Y axis at the ``frame``-th step
    (0-based): the angle starts at atan2(L.z, L.x) and each step adds
    speed*dt before the frame renders, fused; radius and height are kept.
    f32, cosine and sine correctly rounded (numpy's f32 ones are not
    always, and a light an ulp away turns the shadow rays that graze their
    own wall)."""
    f = np.float32
    angle = f(np.arctan2(float(L0[2]), float(L0[0])))
    inc = float(f(speed)) * float(f(dt))
    for _ in range(frame + 1):
        angle = f(float(angle) + inc)
    r = f(np.sqrt(f(L0[0] * L0[0] + L0[2] * L0[2])))
    cos, sin = (f(fn(np.float64(angle))) for fn in (np.cos, np.sin))
    return np.asarray([r * cos, L0[1], r * sin], f)


# ---------------------------------------------------------------- geometry

def _f64(v):
    return v.double() if torch.is_tensor(v) else float(v)


def _fma(a, b, c):
    """a*b + c rounded once to the tensors' precision, as the upstream CUDA
    renderer's compiler fuses it (the product of two f32 values is exact
    in f64).  Where a shadow ray leaves a wall sphere of radius 940-990 at
    eps 1e-4, whether it re-hits the wall hangs on these last bits."""
    dt = next(v.dtype for v in (a, b, c) if torch.is_tensor(v))
    return (_f64(a) * _f64(b) + _f64(c)).to(dt)


def _sqrt(x):
    """Correctly rounded square root (the f64 root rounded)."""
    return torch.sqrt(x.double()).to(x.dtype)


def _cos(x):
    return torch.cos(x.double()).to(x.dtype)


def _sin(x):
    return torch.sin(x.double()).to(x.dtype)


# Cephes logf on [sqrt(1/2)-1, sqrt(2)-1], its multiply-adds fused
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1, _LOG_Q2 = -2.12194440e-4, 0.693359375


def _log(x):
    """f32 natural logarithm of positive normal f32 values: the Cephes
    logf polynomial with its multiply-adds fused (frozen from
    ``raytracinggpu_tpu_torch/core/vec.py`` ``log``, a4aff6f).  Other
    precisions take torch's log."""
    if x.dtype != torch.float32:
        return torch.log(x)
    f = lambda v: float(np.float32(v))
    p = [f(c) for c in _LOG_P]
    bits = x.contiguous().view(torch.int32)
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    e = ((bits >> 23) - 0x7F).to(torch.float32) + 1.0
    small = m < f(0.707106781186547524)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(torch.float32)
    x2 = x * x
    x3 = x2 * x
    y, y1, y2 = (_fma(_fma(x, p[k], p[k + 1]), x, p[k + 2])
                 for k in (0, 3, 6))
    y = _fma(_fma(y, x3, y1), x3, y2)
    y = _fma(y, x3, e * f(_LOG_Q1))
    x = _fma(x2, -0.5, x) + y
    return _fma(e, f(_LOG_Q2), x)


def _dot(a, b):
    """a.b over the first axis, z*z' + (x*x' + y*y') fused."""
    return _fma(a[2], b[2], _fma(a[0], b[0], a[1] * b[1]))


def _cross(a, b):
    return torch.stack([_fma(a[1], b[2], -(a[2] * b[1])),
                        _fma(a[2], b[0], -(a[0] * b[2])),
                        _fma(a[0], b[1], -(a[1] * b[0]))])


def _normalize(v):
    n = _sqrt(_dot(v, v))
    return v / torch.where(n > 0, n, torch.ones_like(n))


def intersect_spheres(sc: Scene, O, u):
    """Nearest sphere: (t (R,), id (R,) int64 or -1, unit normal (3, R))."""
    oc = O[:, None, :] - sc.sc.T[:, :, None]            # (3, S, R)
    b = _dot(u[:, None, :], oc)                         # (S, R)
    delta = _fma(b, b, -(_dot(oc, oc) - (sc.sr * sc.sr)[:, None]))
    sq = _sqrt(torch.clamp_min(delta, 0.0))
    t1, t2 = -b - sq, -b + sq
    t = torch.where(t1 < 0.0, t2, t1)
    t = torch.where((delta >= 0.0) & (t2 >= 0.0), t, torch.full_like(t, INF))
    tmin, j = torch.min(t, 0)
    hit = tmin < INF
    obj = torch.where(hit, j, -1)
    P = _fma(u, torch.where(hit, tmin, torch.zeros_like(tmin)), O)
    N = _normalize(P - sc.sc[j].T)
    return tmin, obj, N


def _slab_hit(O, inv, box):
    """(nb, R) bool: the ray's whole line past its origin meets the box;
    NaN products (a zero direction on a face plane) count as a hit."""
    t0 = (box[:, 0:3, None] - O[None]) * inv[None]
    t1 = (box[:, 3:6, None] - O[None]) * inv[None]
    enter = torch.fmin(t0, t1).nan_to_num(-3.4e38).amax(1)
    exit_ = torch.fmax(t0, t1).nan_to_num(3.4e38).amin(1)
    return (exit_ >= enter) & (exit_ >= 0.0)


def _mt(sc: Scene, O, u, tri):
    """Classic Moller-Trumbore of rays (3, P) against triangle ids (P, K):
    (t with INF where the test fails, beta, gamma), each (P, K)."""
    A, B, C = (v[tri] for v in sc.tris)                 # (P, K, 3)
    e1, e2 = B - A, C - A
    ao = A - O.T[:, None, :]
    uu = u.T[:, None, :]
    ng = torch.cross(e1, e2, dim=-1)
    denom = (uu * ng).sum(-1)
    aoxu = torch.cross(ao, uu.expand_as(ao), dim=-1)
    beta = (e2 * aoxu).sum(-1) / denom
    gamma = -(e1 * aoxu).sum(-1) / denom
    t = (ao * ng).sum(-1) / denom
    ok = ((denom != 0) & (beta >= 0) & (beta <= 1) & (gamma >= 0)
          & (gamma <= 1) & (beta + gamma <= 1) & (t > 0) & (t > sc.eps_leaf))
    return torch.where(ok, t, torch.full_like(t, INF)), beta, gamma


def intersect_mesh(sc: Scene, O, u, normal: bool):
    """Nearest triangle of every ray (3, R): (t (R,), N (3, R) unnormalized
    or None); t INF on a miss.  Ties go to the lowest triangle id."""
    R = O.shape[1]
    dev = O.device
    T = sc.n_tri
    best_t = torch.full((R,), INF, dtype=sc.dtype, device=dev)
    best_id = torch.full((R,), T, dtype=torch.int64, device=dev)
    Of, uf = O.float(), u.float()
    with torch.no_grad():
        inv = 1.0 / uf
        cand = _slab_hit(Of, inv, sc.mbox[None])[0].nonzero()[:, 0]
    for r0 in range(0, cand.numel(), RAY_BLOCK):
        rays = cand[r0:r0 + RAY_BLOCK]
        g, k = _slab_hit(Of[:, rays], inv[:, rays], sc.gbox).nonzero(
            as_tuple=True)
        for p0 in range(0, g.numel(), PAIR_BLOCK):
            gp, rp = g[p0:p0 + PAIR_BLOCK], rays[k[p0:p0 + PAIR_BLOCK]]
            ids = sc.gtab[gp]
            t, _, _ = _mt(sc, O[:, rp], u[:, rp], ids)
            tmin, j = torch.min(t, 1)
            tid = ids.gather(1, j[:, None])[:, 0]
            best_t.scatter_reduce_(0, rp, tmin, "amin")
            win = (tmin == best_t[rp]) & (tmin < INF)
            best_id.scatter_reduce_(0, rp[win], tid[win], "amin")
    if not normal:
        return best_t, None
    hit = best_t < INF
    A, B, C = (v[best_id] for v in sc.tris)
    ng = torch.cross(B - A, C - A, dim=-1).T
    if sc.normals is None:
        return best_t, torch.where(hit, ng, torch.zeros_like(ng))
    _, beta, gamma = _mt(sc, O, u, best_id[:, None])
    beta, gamma = beta[:, 0], gamma[:, 0]
    Na, Nb, Nc = (v[best_id].T for v in sc.normals)
    n = (1.0 - beta - gamma) * Na + beta * Nb + gamma * Nc
    return best_t, torch.where(hit, n, torch.zeros_like(n))


def intersect_all(sc: Scene, O, u):
    """Nearest hit of spheres and mesh: (t, obj, unit N, P); the mesh, the
    last object, wins only strictly nearer."""
    t, obj, N = intersect_spheres(sc, O, u)
    if sc.tris is not None:
        tm, nm = intersect_mesh(sc, O, u, normal=True)
        use = tm < t
        t = torch.where(use, tm, t)
        obj = torch.where(use, sc.sr.shape[0], obj)
        N = torch.where(use, _normalize(nm), N)
    hit = obj >= 0
    P = _fma(u, torch.where(hit, t, torch.zeros_like(t)), O)
    return t, obj, N, P


def shadow_distance(sc: Scene, O, u):
    """Nearest hit distance of the shadow rays, spheres and mesh."""
    t, _, _ = intersect_spheres(sc, O, u)
    if sc.tris is not None:
        t = torch.minimum(t, intersect_mesh(sc, O, u, normal=False)[0])
    return t


# ---------------------------------------------------------------- integrator

def trace(sc: Scene, L, O, u, uniforms):
    """The iterative integrator of the reference's GPU convention:
    ``uniforms`` (D, 2, R) drive the diffuse bounces.  Returns (3, R)."""
    dt, dev = sc.dtype, O.device
    D, R = uniforms.shape[0], O.shape[1]
    L = torch.as_tensor(L, dtype=dt, device=dev)[:, None]
    ri = torch.ones(R, dtype=dt, device=dev)
    eps = sc.eps_bounce
    steps = []
    for d in range(D):
        t, obj, N, P = intersect_all(sc, O, u)
        hit = obj >= 0
        oid = torch.clamp_min(obj, 0)
        mir = hit & sc.mirror[oid]
        iri, ori = sc.in_ri[oid], sc.out_ri[oid]
        refr = hit & ~sc.mirror[oid] & (iri != ori)
        diff = hit & ~mir & ~refr
        udN = _dot(u, N)
        O_m, u_m = _fma(N, eps, P), _fma(-N, 2 * udN, u)
        out2in = ri == ori
        ratio = torch.where(out2in, ori / iri, iri / ori)
        N2 = torch.where(out2in, N, -N)
        cosi = _dot(u, N2)
        sin2t = ratio * ratio * _fma(-cosi, cosi, 1.0)
        denser = torch.where(out2in, ri > iri, ri > ori)
        tir = refr & denser & (sin2t > 1)
        O_t, u_t = _fma(N2, eps, P), _fma(-N2, 2 * cosi, u)
        O_r = _fma(-N2, eps, P)
        u_r = _fma(N2, -_sqrt(torch.clamp_min(1 - sin2t, 0.0)),
                   _fma(-N2, cosi, u) * ratio)
        ri_r = torch.where(out2in, iri, ori)
        P_adj = _fma(N, eps, P)
        Lv = L - P_adj
        sd = _normalize(Lv)
        t_s = shadow_distance(sc, P_adj, sd)
        occ = t_s * t_s <= _dot(Lv, Lv)
        LP = L - P
        wl = _normalize(LP)
        lum = (sc.intensity / (4 * PI * _dot(LP, LP))
               * torch.clamp_min(_dot(N, wl), 0.0)) / PI
        alb = sc.albedo[oid].T
        direct = alb * torch.where(diff & ~occ, lum, torch.zeros_like(lum))
        r1, r2 = uniforms[d, 0], uniforms[d, 1]
        x = _cos(2 * math.pi * r1) * _sqrt(1 - r2)
        y = _sin(2 * math.pi * r1) * _sqrt(1 - r2)
        z = _sqrt(r2)
        cond = (N[1].abs() != 0) & (N[0].abs() != 0)
        zero = torch.zeros_like(N[0])
        T1 = _normalize(torch.where(cond, torch.stack([-N[1], N[0], zero]),
                                    torch.stack([-N[2], zero, N[0]])))
        T2 = _cross(N, T1)
        u_d = _fma(N, z, _fma(T1, x, T2 * y))
        O2 = torch.where(mir, O_m, O)
        u2 = torch.where(mir, u_m, u)
        O2 = torch.where(refr & ~tir, O_r, O2)
        u2 = torch.where(refr & ~tir, u_r, u2)
        O2 = torch.where(tir, O_t, O2)
        u2 = torch.where(tir, u_t, u2)
        ri = torch.where(refr & ~tir, ri_r, ri)
        O = torch.where(diff, P_adj, O2)
        u = torch.where(diff, u_d, u2)
        ri = torch.where(diff, torch.ones_like(ri), ri)
        steps.append((diff, direct, alb))
    ans = torch.zeros((3, R), dtype=dt, device=dev)
    for diff, direct, alb in reversed(steps):
        ans = torch.where(diff, _fma(alb, ans, direct), ans)
    return ans


# ---------------------------------------------------------------- camera

def camera_basis(cam: dict):
    """(C, bx, by, bz) f32 numpy of a configuration's ``camera``: the
    identity basis, or the yaw/pitch basis of ``realtime_render.cu``'s
    rotate() (yaw about +Y, then pitch about the new right axis)."""
    f = np.float32
    C = np.asarray(cam["position"], f)
    if cam["kind"] == "fixed":
        return C, *np.eye(3, dtype=f)
    yaw, pitch = f(cam["yaw"]), f(cam["pitch"])
    bx, by, bz = (np.asarray(v, f) for v in ((1, 0, 0), (0, 1, 0),
                                             (0, 0, -1)))
    bx = bx * np.cos(yaw) + bz * np.sin(yaw)
    bz = np.cross(by, bx)
    by = by * np.cos(pitch) - bz * np.sin(pitch)
    bz = np.cross(bx, by)
    n = lambda v: (v / np.sqrt((v * v).sum())).astype(f)
    return C, n(bx), n(by), n(bz)


def render_rows(sc: Scene, view: dict, key, rows, spp: int, max_depth: int,
                L) -> torch.Tensor:
    """Radiance (nr, W, 3) float32 of the global ``rows`` of a frame: spp
    samples, sample s keyed by fold_in(key, s), averaged.  ``view`` holds
    width, height, fov, sigma and the camera; ``L`` the light position."""
    W, H = view["width"], view["height"]
    dev, dt = sc.sc.device, sc.dtype
    C, bx, by, bz = (torch.as_tensor(v, device=dev).to(dt)[:, None]
                     for v in camera_basis(view["camera"]))
    rows_t = torch.as_tensor(np.asarray(rows), dtype=torch.int64, device=dev)
    nr = rows_t.shape[0]
    x = torch.arange(W, dtype=torch.float32, device=dev)
    ux = (x - W / 2.0 + 0.5).repeat(nr).to(dt)
    uy = (H / 2.0 - rows_t.float() - 0.5).repeat_interleave(W).to(dt)
    z = float(np.float32(-W / (2.0 * np.tan(view["fov"] / 2.0))))
    n = nr * W
    group = max(1, min(spp, RAYS_PER_TRACE // n))
    acc = torch.zeros((3, n), dtype=torch.float32, device=dev)
    for s0 in range(0, spp, group):
        us, ds = [], []
        for s in range(s0, min(spp, s0 + group)):
            un = row_uniforms(fold_in(key, s), rows_t, W, max_depth)
            un = un.reshape(max_depth + 1, 2, n).to(dt)
            r1, r2 = un[0, 0], un[0, 1]
            mag = view["sigma"] * _sqrt(-2.0 * _log(r1))
            c, sn = _cos(2 * math.pi * r2), _sin(2 * math.pi * r2)
            if view["camera"]["kind"] == "fixed":
                d = (bx * _fma(mag, c, ux) + by * _fma(mag, sn, uy)
                     + bz * z)
            else:  # the reference's camera point: C added into the ray
                d = _fma(bx, ux, C + bz * z) + by * uy
                d = torch.stack([_fma(mag, c, d[0]), _fma(mag, sn, d[1]),
                                 d[2]])
            us.append(un[1:])
            ds.append(_normalize(d))
        u = torch.cat(ds, 1)
        O = C.expand(3, u.shape[1])
        col = trace(sc, L, O, u, torch.cat(us, 2)).float()
        for c in col.split(n, 1):  # added in sample order
            acc += c
    img = acc / spp
    return img.T.reshape(nr, W, 3)
