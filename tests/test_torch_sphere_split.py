"""The identities rt_sphere_hit's sphere loop rests on (csrc/wavefront.cu),
held on the CPU with numpy, and a numpy model of that loop held bitwise
against the plain version, ``ops/sphere.sphere_hit_plain``.

The loop keeps each f32 value in an f64 and rounds it with Veltkamp's
split (``round24``), tests its deltas with ``tiny_key``, reads b and delta
back as f32 with integer operations (``narrow24``), takes ``sqrtf`` for the
f64 root rounded to f32, and runs only on lanes and tables whose every
component passes ``moderate``.  The functions below are those of the
kernel, written with numpy's IEEE f64 and uint32 arithmetic; the card's
DMUL, DADD and DFMA round as numpy's do.  ``chip_smoke.py``'s phase 21
sweeps the same identities over all 2^32 f32 patterns on the card.
"""
import numpy as np
import pytest
import torch

from raytracinggpu_tpu_torch.bench.depth_step import sphere_edge_calls
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.sphere import SphereTable, sphere_hit_plain
from raytracinggpu_tpu_torch.scene.presets import build_preset

SPLIT = 2.0**29 + 1
TINY_KEY = (897 << 21) - 1
INF_T = np.float32(1e9)
U32 = np.uint32


def round24(x):
    """Veltkamp's split: x rounded to 24 significant bits, ties to even."""
    c = x * SPLIT
    return c - (c - x)


def _words(x):
    b = np.asarray(x, np.float64).view(np.uint64)
    return (b >> 32).astype(U32), (b & 0xFFFFFFFF).astype(U32)


def tiny_key(x):
    """(hi << 1) - 1 of x's bits, modulo 2^32."""
    hi, _ = _words(x)
    return (hi << U32(1)) - U32(1)


def accepted(r):
    """The loop's test of a rounded delta (tiny_key at least TINY_KEY) and
    the bound moderate inputs keep it under."""
    with np.errstate(invalid="ignore"):
        return (tiny_key(r) >= TINY_KEY) & (np.abs(r) < 2.0**128)


def in_domain(x):
    """tiny_key's domain: 0, or at least 2^-1042 in magnitude (a high word
    that is not 0; every delta the loop forms is a multiple of 2^-252)."""
    with np.errstate(invalid="ignore"):
        return (x == 0) | ~(np.abs(x) < 2.0**-1042)


def narrow24(x):
    """The f32 an f64 holding 0 or an f32 normal stands for, by integer
    operations: the exponent rebased by 896, clamped at 0, shifted in."""
    hi, lo = _words(x)
    e = np.maximum((hi & U32(0x7FFFFFFF)).astype(np.int64) - (896 << 20), 0)
    e = e.astype(U32)
    bits = (e << U32(3)) | (lo >> U32(29)) | (hi & U32(0x80000000))
    return bits.view(np.float32)


def moderate(v):
    """0, or of magnitude in [2^-40, 2^30)."""
    m = np.asarray(v, np.float32).view(U32) & U32(0x7FFFFFFF)
    return (m == 0) | ((m - U32(87 << 23)) < U32(70 << 23))


def f32_of(x):
    with np.errstate(over="ignore"):
        return np.asarray(x, np.float64).astype(np.float32)


def same64(a, b):
    return np.array_equal(np.asarray(a).view(np.uint64),
                          np.asarray(b).view(np.uint64))


# ---------------------------------------------------------------- rounding

def _ties(rng, n):
    """f32 values over every normal binade, both signs, and the doubles
    half an ulp above and below each (exact ties), one f64 ulp either side
    of those (near ties), and the values themselves."""
    f = (rng.uniform(1, 2, n) * 2.0 ** rng.integers(-126, 128, n))
    f = f32_of(f * np.where(rng.random(n) < 0.5, -1.0, 1.0))
    d = f.astype(np.float64)
    h = np.ldexp(1.0, np.maximum(
        (f.view(U32) >> U32(23)).astype(np.int64) & 0xFF, 1) - 151)
    mids = np.concatenate([d + h, d - h, d])
    return np.concatenate([mids, np.nextafter(mids, np.inf),
                           np.nextafter(mids, -np.inf)])


def _sets():
    rng = np.random.default_rng(19)
    n = 200_000
    rand = rng.uniform(-1, 1, n) * 2.0 ** rng.uniform(-135, 135, n)
    a = f32_of(rng.uniform(-1, 1, n) * 2.0 ** rng.uniform(-60, 60, n))
    b = f32_of(rng.uniform(-1, 1, n) * 2.0 ** rng.uniform(-60, 60, n))
    c = f32_of(rng.uniform(-1, 1, n) * 2.0 ** rng.uniform(-120, 120, n))
    # core/vec.fma's shape: the exact f64 product of two f32 plus an f32
    fma_sums = a.astype(np.float64) * b.astype(np.float64) + c
    tiny = np.array([2.0**-126, np.nextafter(2.0**-126, 0),
                     2.0**-126 - 2.0**-150, 2.0**-126 - 2.0**-151,
                     2.0**-127, 2.0**-149, 2.0**-150, 2.0**-1074, 1e-310,
                     2.0**-252, 0.0, -0.0])
    huge = np.array([2.0**128, np.nextafter(2.0**128, 0),
                     2.0**128 - 2.0**103, 2.0**128 - 2.0**104,
                     np.finfo(np.float32).max, 2.0**995, 2.0**1000,
                     np.finfo(np.float64).max, np.inf, -np.inf, np.nan])
    edges = np.concatenate([tiny, -tiny, huge, -huge])
    return {"random doubles over 2^+-135": rand,
            "exact and near ties over every binade": _ties(rng, n // 4),
            "fma64 sums": fma_sums,
            "edges: 0, subnormals, 2^-126 and 2^128 each side, inf, NaN":
                edges}


SETS = _sets()


@pytest.mark.parametrize("name", list(SETS))
def test_round24_is_the_f32_rounding_where_accepted(name):
    """Wherever the loop's test accepts round24(x) (0 or [2^-126, 2^128)),
    it equals (double)(float)x; and every x whose f32 rounding is such a
    value and lies above the test's edge is accepted."""
    x = SETS[name]
    with np.errstate(all="ignore"):
        r = round24(x)
        want = f32_of(x).astype(np.float64)
    ok = accepted(r) & in_domain(x)
    assert same64(r[ok], want[ok])
    fine = np.isfinite(want) & ((want == 0) | (np.abs(want) >= 2.0**-126))
    fine &= in_domain(x)
    # rejected but fine: only just under 2^-126, where round24 keeps a bit
    # the f32 grid has not
    missed = fine & ~ok
    assert np.all(np.abs(x[missed]) < 2.0**-126)
    assert ok.sum() > 0.5 * len(x) or name.startswith("edges")


@pytest.mark.parametrize("name", list(SETS))
def test_narrow24_reads_the_f32_of_an_accepted_value(name):
    x = SETS[name]
    with np.errstate(all="ignore"):
        r = round24(x)
    ok = accepted(r) & in_domain(x)
    got = narrow24(r[ok]).view(U32)
    assert np.array_equal(got, f32_of(x[ok]).view(U32))


def test_tiny_key_marks_exactly_the_nonzero_values_under_2_126():
    rng = np.random.default_rng(3)
    x = np.concatenate([
        rng.uniform(-1, 1, 100_000) * 2.0 ** rng.uniform(-300, 300, 100_000),
        [0.0, -0.0, 2.0**-126, -2.0**-126, np.nextafter(2.0**-126, 0),
         2.0**-1074, -2.0**-1074, 2.0**-252]])
    x = x[in_domain(x)]
    want = (x != 0) & (np.abs(x) < 2.0**-126)
    assert np.array_equal(tiny_key(x) < TINY_KEY, want)
    # below the domain the high word is 0, as a zero's
    assert tiny_key(np.array([2.0**-1074]))[0] == tiny_key(np.zeros(1))[0]


def test_moderate_bounds():
    f = np.float32
    inside = np.array([0.0, -0.0, 2.0**-40, -2.0**-40, 1.0, -940.0,
                       np.nextafter(f(2.0**30), f(0))], f)
    outside = np.array([np.nextafter(f(2.0**-40), f(0)), 2.0**30, -2.0**30,
                        1e-42, 1e30, np.inf, -np.inf, np.nan], f)
    assert moderate(inside).all() and not moderate(outside).any()


@pytest.mark.parametrize("part", range(4))
def test_sqrt_in_f64_rounded_to_f32_is_the_f32_sqrt(part):
    """float(sqrt(double(x))) against the f32 sqrt on a strided sample of
    all 2^32 f32 bit patterns (a quarter of the sample a case), NaN alike:
    rounding twice is harmless for sqrt when 53 >= 2 * 24 + 2."""
    bits = np.arange(part, 2**32, 4 * 1021, dtype=np.uint64).astype(U32)
    x = bits.view(np.float32)
    with np.errstate(invalid="ignore"):
        a = np.sqrt(x)
        b = np.sqrt(x.astype(np.float64)).astype(np.float32)
    nan = np.isnan(a) & np.isnan(b)
    assert np.array_equal(a.view(U32)[~nan], b.view(U32)[~nan])
    assert np.array_equal(np.isnan(a), np.isnan(b))


# ----------------------------------------------------- the loop, modelled

def fast_loop(O, u, cen, rad):
    """The kernel's fast loop on (R, 3) f32 rays and (S, 3), (S,) spheres:
    (t, argmin, fast): fast where the lane's, the table's and every
    delta's tests pass (elsewhere the kernel runs its exact loop)."""
    f32 = np.float32
    o, d = O.astype(np.float64), u.astype(np.float64)
    lane_ok = moderate(O).all(1) & moderate(u).all(1)
    table_ok = bool(moderate(cen).all() and moderate(rad).all())
    best = np.full(len(O), np.inf, f32)
    arg = np.zeros(len(O), np.int32)
    key = np.full(len(O), 0xFFFFFFFF, U32)
    with np.errstate(all="ignore"):
        for s in range(len(rad)):
            ocx, ocy, ocz = (round24(o[:, j] - np.float64(cen[s, j]))
                             for j in range(3))
            b = round24(d[:, 2] * ocz + round24(
                d[:, 0] * ocx + round24(d[:, 1] * ocy)))
            n2 = round24(ocz * ocz + round24(ocx * ocx + round24(ocy * ocy)))
            rr = np.float64(rad[s] * rad[s])
            delta = round24(b * b - round24(n2 - rr))
            key = np.minimum(key, tiny_key(delta))
            dl, nb = narrow24(delta), -narrow24(b)
            sq = np.sqrt(np.where(np.isnan(dl), dl, np.maximum(dl, f32(0))))
            t1, t2 = nb - sq, nb + sq
            valid = (dl >= 0) & (t2 >= 0)
            t = np.where(valid, np.where(t1 < 0, t2, t1), INF_T)
            upd = t < best
            best = np.where(upd, t, best)
            arg = np.where(upd, s, arg)
    return best, arg, lane_ok & table_ok & (key >= TINY_KEY)


def _hold(O, u, cen, rad):
    """The model against sphere_hit_plain on the lanes it calls fast:
    t bit for bit and obj on the hits; returns the fast share."""
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tab = SphereTable(*(T(cen[:, j]) for j in range(3)), T(rad))
    t, obj, _ = sphere_hit_plain(Vec3(*T(O.T)), Vec3(*T(u.T)), tab)
    t, obj = t.numpy(), obj.numpy()
    best, arg, fast = fast_loop(O, u, cen, rad)
    assert np.array_equal(best[fast].view(U32), t[fast].view(U32))
    hit = fast & (t < INF_T)
    assert np.array_equal(arg[hit], obj[hit])
    return fast.mean()


@pytest.fixture(scope="module")
def spheres():
    _, tables = build_preset("showcase", "cpu", width=16, height=16, spp=1,
                             max_depth=1)
    return tables.spheres


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_loop_model_bitwise_on_rays_in_the_box(spheres, seed):
    """Rays inside the box (origins anywhere in it, on a sphere's surface,
    tangent to it, at its centre) all take the fast loop and give the
    plain version's bits."""
    rng = np.random.default_rng(seed)
    cen = np.stack([c.numpy() for c in spheres[:3]], 1)
    rad = spheres.radius.numpy()
    R = 50_000
    O = rng.uniform(-60, 60, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3))
    u = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    k = rng.integers(0, 4, R)
    s = rng.integers(0, len(rad), R)
    n = rng.normal(size=(R, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    surf = (cen[s] + rad[s, None] * n).astype(np.float32)
    tan = np.cross(n, rng.normal(size=(R, 3)))
    tan /= np.linalg.norm(tan, axis=1, keepdims=True)
    O[k == 1] = surf[k == 1]
    O[k == 2] = (surf + 2.0 * tan)[k == 2].astype(np.float32)
    u[k == 2] = (-tan)[k == 2].astype(np.float32)
    O[k == 3] = cen[s[k == 3]]
    assert _hold(O, u, cen, rad) == 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_loop_model_bitwise_on_edge_lanes(spheres, seed):
    """bench/depth_step.sphere_edge_calls' lanes and tables: the moderate
    bounds each side, tiny origins, rays leaving a sphere of radius 2^-35
    with b * b at 0, an f32 subnormal or a normal; the model's fast lanes
    give the plain bits, and the subnormal deltas are not among them."""
    calls = sphere_edge_calls(spheres, R=8192, seed=seed)
    seen = set()
    for _, label, kind, args in calls:
        if kind != "closest":
            continue
        O, u, tab = args
        O = np.stack([c.numpy() for c in O], 1)
        u = np.stack([c.numpy() for c in u], 1)
        cen = np.stack([c.numpy() for c in tab[:3]], 1)
        rad = tab.radius.numpy()
        share = _hold(O, u, cen, rad)
        seen.add((label, share > 0))
        _, _, fast = fast_loop(O, u, cen, rad)
        # a lane leaving the tiny sphere at a slant of 2^-40 or 2^-30 has
        # delta 2^-150 or 2^-130: never fast
        slant = (np.abs(u).min(1) == 0) & np.isin(
            np.sort(np.abs(u), 1)[:, 1], [2.0**-40, 2.0**-30]) & (
            np.abs(O).max(1) == np.float32(2.0**-35))
        assert slant.any() and not (fast & slant).any()
    assert {s for _, s in seen} == {True, False}  # the 2^-100 table: none


@pytest.mark.parametrize("outer", [False, True])
def test_sass_loop_counts_read_a_sphere_loop(outer):
    """bench/sphere_scatter_design.loop_counts on a listing of cuobjdump's
    form: the innermost loop that holds a MUFU, its classes counted, the
    loop without one and the trailing self-branch left out; with ``outer``
    both loops sit in a loop over them, which is not innermost."""
    from raytracinggpu_tpu_torch.bench.sphere_scatter_design import (
        loop_counts)

    listing = [(0x00, "S2R R0, SR_TID.X"), (0x10, "IADD3 R1, R0, 0x1, RZ"),
               (0x20, "@P0 BRA 0x10"),
               (0x30, "DADD R2, R4, -R6"), (0x40, "@!P0 DFMA R2, R4, R6, R8"),
               (0x50, "MUFU.RSQ R3, R2"), (0x60, "F2F.F64.F32 R4, R3"),
               (0x70, "FADD R1, R2, R3"), (0x80, "FSETP.GT.AND P1, PT, R1, RZ"),
               (0x90, "@P1 BRA 0x30")]
    if outer:
        listing.append((0x98, "@P2 BRA 0x0"))
    listing += [(0xa0, "EXIT"), (0xb0, "BRA 0xb0")]
    (rng, counts, mufu, n), = loop_counts(listing)
    assert rng == (0x30, 0x90) and mufu == 1 and n == 7
    assert counts == {"F2F (f32<->f64)": 1, "f64 DADD/DMUL/DFMA/DSETP": 2,
                      "MUFU": 1, "f32 FADD/FMUL/FFMA": 1,
                      "integer, logic, compare, select": 1}

