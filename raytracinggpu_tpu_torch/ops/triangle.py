"""Ray-triangle intersection as a matrix product: the dense oracle
traversal (port of ``raytracinggpu_tpu/ops/triangle.py``).

Moller-Trumbore factorizes into inner products of a 10-feature ray vector

    f(ray) = [u, w = O x u, O, 1]            (shape (R, 10))

with a per-triangle constant matrix (shape (10, 4, T)):

    denom      = u.Ng
    beta*denom = u.(e2 x A) - w.e2
    gamma*denom = w.e1 - u.(e1 x A)
    t*denom    = A.Ng - O.Ng

so one (R, 10) x (10, 4T) product tests every (ray, triangle) pair, and a
running min over triangle blocks keeps memory at O(R * block).  The JAX
package leaves that product to XLA, outside any Pallas kernel; here it is
``torch.matmul`` in full f32 (TF32 off on the card: reduced precision
flips hit/miss decisions).  Its 10-term sums round in another order than
the MT kernels', so the oracle is held to a tolerance, never bitwise.

The tables are built on the host in f32 numpy from the BVH-ordered
triangles, as the JAX package builds them, and land on the caller's
device.  ``cornersT`` rows [na, nb, nc, Ng, pad] serve the winner-normal
gathers of every traversal.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.vec import Vec3

INF = 1e9 + 9
INF32 = float(np.float32(INF))

# Feature count of the ray vector [u(3), O x u(3), O(3), 1].
NUM_RAY_FEATURES = 10
# Outputs per triangle: denom, beta_num, gamma_num, t_num.
NUM_TRI_OUTPUTS = 4


class TriTables(NamedTuple):
    """Per-triangle intersection tables on one device.

    mt: (10, 4, Tp) f32, the Moller-Trumbore feature matrix.
    ng: Vec3 of (Tp,), the geometric normal e1 x e2 (unnormalized).
    na, nb, nc: Vec3 of (Tp,), per-corner vertex normals; zeros when absent.
    cornersT: (Tp, 16) f32 [na, nb, nc, Ng, pad]: one row gather per ray.
    n_tri: true (unpadded) triangle count.
    Padding triangles are all zeros: denom == 0, so they never hit.
    """

    mt: torch.Tensor
    ng: Vec3
    na: Vec3
    nb: Vec3
    nc: Vec3
    cornersT: torch.Tensor
    n_tri: int


class TriHit(NamedTuple):
    """Closest mesh hit.  t (R,) f32, INF on a miss; idx (R,) int32 triangle
    index (BVH order), 0 on a miss; beta, gamma (R,) the winner's
    barycentrics where the query computes them (the dense oracle), else
    None (recover them with ``pallas_trace.recompute_barycentrics``)."""

    t: torch.Tensor
    idx: torch.Tensor
    beta: torch.Tensor | None = None
    gamma: torch.Tensor | None = None


def build_tri_tables(A, B, C, device, na=None, nb=None, nc=None,
                     pad_to: int | None = None) -> TriTables:
    """Tables from BVH-ordered triangle corners (T, 3) on ``device``."""
    A = np.asarray(A, np.float32)
    B = np.asarray(B, np.float32)
    C = np.asarray(C, np.float32)
    T = A.shape[0]
    Tp = pad_to if pad_to is not None else T
    if Tp < T:
        raise ValueError(f"pad_to={Tp} is below the triangle count {T}")

    def pad(v):
        return np.pad(v, ((0, Tp - T), (0, 0)))

    Ap, Bp, Cp = pad(A), pad(B), pad(C)
    e1 = Bp - Ap
    e2 = Cp - Ap
    ng = np.cross(e1, e2)

    m = np.zeros((NUM_RAY_FEATURES, NUM_TRI_OUTPUTS, Tp), np.float32)
    m[0:3, 0, :] = ng.T                      # denom = u . Ng
    m[0:3, 1, :] = np.cross(e2, Ap).T        # beta_num = u.(e2 x A) - w.e2
    m[3:6, 1, :] = -e2.T
    m[0:3, 2, :] = -np.cross(e1, Ap).T       # gamma_num = w.e1 - u.(e1 x A)
    m[3:6, 2, :] = e1.T
    m[6:9, 3, :] = -ng.T                     # t_num = A.Ng - O.Ng
    m[9, 3, :] = np.einsum("td,td->t", Ap, ng)

    def padn(v):
        if v is None:
            return np.zeros((Tp, 3), np.float32)
        return pad(np.asarray(v, np.float32))

    corners = np.zeros((Tp, 16), np.float32)
    corners[:, 0:3] = padn(na)
    corners[:, 3:6] = padn(nb)
    corners[:, 6:9] = padn(nc)
    corners[:, 9:12] = ng

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    vec = lambda v: Vec3(*(t(v[:, k]) for k in range(3)))
    return TriTables(mt=t(m), ng=vec(ng), na=vec(padn(na)), nb=vec(padn(nb)),
                     nc=vec(padn(nc)), cornersT=t(corners), n_tri=T)


def ray_features(O: Vec3, u: Vec3) -> torch.Tensor:
    """f(ray) = [u, O x u, O, 1], shape (R, 10)."""
    w = O.cross(u)
    one = torch.ones_like(u.x)
    return torch.stack([u.x, u.y, u.z, w.x, w.y, w.z, O.x, O.y, O.z, one],
                       dim=-1)


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 products in full f32 (no TF32) inside the block, whatever the
    process set; the setting is restored on exit."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(before)


def _block_mt(f, mt_block, eps):
    """MT over one triangle block: f (R, 10) x mt_block (10, 4, Tb) ->
    (t masked to INF where invalid, beta, gamma), each (R, Tb)."""
    Tb = mt_block.shape[-1]
    out = (f @ mt_block.reshape(NUM_RAY_FEATURES, -1)).reshape(-1, 4, Tb)
    denom = out[:, 0, :]
    beta = out[:, 1, :] / denom
    gamma = out[:, 2, :] / denom
    t = out[:, 3, :] / denom
    valid = ((denom != 0.0)
             & (beta >= 0.0) & (beta <= 1.0)
             & (gamma >= 0.0) & (gamma <= 1.0)
             & (beta + gamma <= 1.0)
             & (t > 0.0) & (t > eps))
    return torch.where(valid, t, INF32), beta, gamma


def intersect_tris_dense(O: Vec3, u: Vec3, tab: TriTables, eps_leaf: float,
                         block_tris: int = 512) -> TriHit:
    """Closest hit over all triangles: a scan over triangle blocks with a
    running min (never materializes (R, T)).  Within a block the lowest
    index wins exact-t ties, and a later block replaces the running winner
    only on a strictly smaller t, so the lowest index wins overall; beta
    and gamma come from the winner."""
    Tp = tab.mt.shape[-1]
    if block_tris <= 0 or Tp % block_tris:
        raise ValueError(f"tri_block={block_tris} does not divide the "
                         f"padded triangle count {Tp}")
    eps = float(np.float32(eps_leaf))
    f = ray_features(O, u)
    dev = f.device
    t_best = torch.full_like(O.x, INF32)
    i_best = torch.zeros(O.x.shape, dtype=torch.int32, device=dev)
    b_best = torch.zeros_like(O.x)
    g_best = torch.zeros_like(O.x)
    iota = torch.arange(block_tris, dtype=torch.int32, device=dev)
    with _full_f32_matmul():
        for base in range(0, Tp, block_tris):
            t, beta, gamma = _block_mt(f, tab.mt[..., base:base + block_tris],
                                       eps)
            t_loc = t.amin(dim=1)
            j = torch.where(t == t_loc[:, None], iota, block_tris).amin(dim=1)
            j = j.clamp_max(block_tris - 1).long()
            better = t_loc < t_best
            t_best = torch.where(better, t_loc, t_best)
            i_best = torch.where(better, base + j.to(torch.int32), i_best)
            b_best = torch.where(better, beta.gather(1, j[:, None])[:, 0],
                                 b_best)
            g_best = torch.where(better, gamma.gather(1, j[:, None])[:, 0],
                                 g_best)
    return TriHit(t=t_best, idx=i_best, beta=b_best, gamma=g_best)


def _corner_rows(tab: TriTables, idx):
    return tab.cornersT[idx.long()]


def geometric_normal(tab: TriTables, hit: TriHit) -> Vec3:
    """Unnormalized geometric normal e1 x e2 of the winner: one (R, 16) row
    gather."""
    rows = _corner_rows(tab, hit.idx)
    return Vec3(rows[:, 9], rows[:, 10], rows[:, 11])


def phong(rows, alpha, beta, gamma, col: int = 0) -> Vec3:
    """na*alpha + nb*beta + nc*gamma from gathered rows whose columns
    col..col+8 hold na, nb, nc; the sums rounded as XLA:CPU fuses them
    (``Vec3.fma``)."""
    v = lambda k: Vec3(*(rows[:, col + 3 * k + a] for a in range(3)))
    return v(2).fma(gamma, v(0).fma(alpha, v(1) * beta))


def smooth_normal(tab: TriTables, hit: TriHit) -> Vec3:
    """Phong-interpolated vertex normal at the hit, unnormalized:
    alpha = 1 - beta - gamma, N = alpha*na + beta*nb + gamma*nc.  One row
    gather; needs the hit's barycentrics (the dense oracle's)."""
    alpha = 1.0 - hit.beta - hit.gamma
    return phong(_corner_rows(tab, hit.idx), alpha, hit.beta, hit.gamma)
