"""The port's compaction ladder (raytracinggpu_tpu_torch/ops/pairs_trace.py,
integrator/wavefront.depth_configs) against the JAX package's
(raytracinggpu_tpu/ops/pairs_trace.py, tests/test_compact.py).

- ``_key_mode``, ``_compact_ok``, ``_compact_tiers`` and ``_coarse_aabb``
  give the JAX results exactly, on the cases of tests/test_compact.py.
- ``_compact_src`` (the source lanes and the active count) is bitwise the
  JAX one on 8,192 seeded scattered rays over the cat's tile boxes, with
  and without ``cap`` and ``active``, on the exact and a coarse key: the
  key's slab test has no multiply-add.
- A compacted cast equals the full-width cast bit for bit: B1 (geometric
  normal), B3 (smooth normal) on every lane and B2 on the active lanes
  (an inactive shadow lane is "don't care": the full cast leaks its
  subgroup-mates' tiles into it, the compacted one returns INF), at
  fractions 0.25 (the cast compacts) and 0.05 (the closest cast
  overflows and runs at full width), with a cap past every hit.  With
  seeded finite caps the two agree on every lane whose full-width t is
  at most its cap, and elsewhere both give a t past the cap or INF.  A
  cast that overflows every tier sorts nothing.
- Frames: the configurations of tests/test_compact.py's
  ``test_render_parity_with_overflow`` (48x48, spp 2, depth 3) and the
  ladder at every depth (``pairs_compact_min_depth`` 0), with casts
  padded to 128 rays so that the tiers take and overflow, and the
  default config, each bitwise the frame with every tier at 0.
- The port's default (ladder) frame against the JAX package's default
  frame at the per-frame standard of tests/test_golden.py: fewer than 0.5%
  of pixels off by more than 1e-4*|g| + 1.0.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.ops import pairs_trace as jpt
from raytracinggpu_tpu.render.pipeline import (
    render_preset_frame as j_render_preset_frame,
)
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu.scene.scene import RenderConfig as JRenderConfig
from raytracinggpu_tpu_torch.bench import ladder as ladder_bench
from raytracinggpu_tpu_torch.convert import render_config_from_dict
from raytracinggpu_tpu_torch.core.vec import Vec3 as PV
from raytracinggpu_tpu_torch.integrator.wavefront import depth_configs
from raytracinggpu_tpu_torch.ops import pairs_trace as ppt
from raytracinggpu_tpu_torch.parallel.multihost_demo import dryrun_legs
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    render_frame,
    render_preset_frame,
    render_rows,
)
from raytracinggpu_tpu_torch.scene.mesh import load_cat_mesh
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH
from raytracinggpu_tpu_torch.scene.presets import build_preset
from raytracinggpu_tpu_torch.scene.scene import RenderConfig

torch.set_num_threads(2)

R = 8192
LADDER = ("pairs_compact", "pairs_compact2", "pairs_compact3",
          "pairs_key_coarse", "pairs_compact_min_depth")
OFF = dict(pairs_compact=0.0, pairs_compact2=0.0, pairs_compact3=0.0)
FRAME = dict(width=48, height=48, spp=2, max_depth=3)


@pytest.fixture(scope="module")
def cat():
    """The cat of tests/test_compact.py, its pairs tables in both
    packages (bitwise the same: tests/test_torch_scene.py)."""
    mesh = load_cat_mesh(CAT_OBJ_PATH, False, 0.6, (0.0, -10.0, 0.0))
    return (jpt.build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh),
            ppt.build_pairs_tables(mesh.A, mesh.B, mesh.C, mesh.bvh, "cpu"))


@pytest.fixture(scope="module")
def rays():
    """tests/test_compact.py's scattered rays, a seeded cap and mask."""
    rng = np.random.default_rng(7)
    O = rng.uniform(-25, 25, (R, 3)).astype(np.float32)
    d = rng.normal(size=(R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cap = rng.uniform(0.0, 40.0, R).astype(np.float32)
    act = rng.uniform(size=R) < 0.5
    return O, d, cap, act


def _j(a):
    return JV(*(jnp.asarray(a[:, i]) for i in range(3)))


def _p(a):
    return PV(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _tiers_taken(monkeypatch):
    """Record (tiers, active count, the tier taken) of every ladder cast."""
    seen = []
    tier = ppt._tier

    def recording(tiers, count):
        C = tier(tiers, count)
        seen.append((tuple(tiers), int(count[0]), C))
        return C

    monkeypatch.setattr(ppt, "_tier", recording)
    return seen


# ---------------------------------------------------------------- the rules

@pytest.mark.parametrize("nc,n", [(31, 1 << 21), (31, (1 << 21) + 1),
                                  (16384, 1 << 16), (16384, (1 << 16) + 1),
                                  (40, 524288), (2053, 524288),
                                  (65, 524288)])
def test_key_mode_matches_jax(nc, n):
    assert ppt._key_mode(nc, n) == jpt._key_mode(nc, n)


@pytest.mark.parametrize("args,want", [
    ((0.0, 31, 262144, 4096), 0), ((0.25, 31, 262144, 4096), 65536),
    ((0.25, 200, 262144, 4096), 65536), ((0.25, 200, 1 << 24, 4096), 0),
    ((0.25, 16384, 1 << 16, 4096), 16384),
    ((0.25, 16384, (1 << 16) + 8, 4096), 0), ((0.9, 31, 8192, 4096), 0),
    ((0.1, 31, 262144, 4096), 28672)])
def test_compact_ok_matches_jax(args, want):
    assert ppt._compact_ok(*args) == jpt._compact_ok(*args) == want


@pytest.mark.parametrize("args,want", [
    (((0.25, 0.0, 0.1), 31, 262144, 4096), [28672, 65536]),
    (((0.1, 0.105), 31, 262144, 4096), [28672]),
    (((0.9,), 31, 8192, 4096), []),
    (((0.0, 0.0, 0.0), 31, 262144, 4096), []),
    (((0.078125, 0.1328125, 0.1875), 40, 524288, 4096),
     [40960, 69632, 98304])])
def test_compact_tiers_match_jax(args, want):
    assert ppt._compact_tiers(*args) == jpt._compact_tiers(*args) == want


@pytest.mark.parametrize("nc,g", [(7, 4), (40, 4), (40, 8), (40, 32),
                                  (40, 1)])
def test_coarse_aabb_matches_jax(nc, g):
    """g-tile unions in tree order, the tail padded with the last box,
    bitwise JAX's; every tile box lies inside its union."""
    rng = np.random.default_rng(3)
    mn = rng.uniform(-5, 5, (nc, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 2.0, (nc, 3)).astype(np.float32)
    aabb = np.concatenate([mn, mx, np.zeros((nc, 2), np.float32)], axis=1)
    want, jng = jpt._coarse_aabb(jnp.asarray(aabb), nc, g)
    got, ng = ppt._coarse_aabb(torch.from_numpy(aabb), nc, g)
    assert ng == jng == -(-nc // g)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    grp = np.arange(nc) // g
    assert (got.numpy()[grp, 0:3] <= mn).all()
    assert (got.numpy()[grp, 3:6] >= mx).all()


def test_compact_src_grouping():
    """tests/test_compact.py's two boxes and eight rays: rays 1 and 5 hit
    box 0, ray 3 only box 1; the src lanes group by first box, then the
    inactive lanes in order."""
    aabb = np.zeros((2, 8), np.float32)
    aabb[0, 0:6] = (0, 0, 0, 1, 1, 1)
    aabb[1, 0:6] = (2, 0, 0, 3, 1, 1)
    O = np.tile(np.float32([-1.0, 0.5, 0.5]), (8, 1))
    O[3, 0] = 1.5
    d = np.tile(np.float32([1.0, 0.0, 0.0]), (8, 1))
    for i, y in ((0, 1.0), (2, -1.0), (4, 1.0), (6, 1.0), (7, 1.0)):
        d[i] = (0.0, y, 0.0)
    js, jn = jpt._compact_src(_j(O), _j(d), jnp.asarray(aabb), 2, None, None,
                              8, 8)
    ps, pn = ppt._compact_src(_p(O), _p(d), torch.from_numpy(aabb), 2, None,
                              None, 8, 8)
    assert int(pn) == int(jn) == 3
    assert ps.dtype == torch.int32
    assert ps.tolist() == np.asarray(js).tolist() == [1, 5, 3, 0, 2, 4, 6, 7]


@pytest.mark.parametrize("with_cap,with_active,g", [
    (False, False, 1), (True, False, 1), (False, True, 1), (True, True, 1),
    (True, True, 4)])
def test_compact_src_matches_jax(cat, rays, with_cap, with_active, g):
    """Bitwise: the source lanes of a 2,048-ray tier and the active count,
    the last 5 lanes padding (never active)."""
    jtab, _ = cat
    O, d, cap, act = rays
    aabb = np.array(jtab.tile_aabb)
    nc = aabb.shape[0]
    kn = -(-nc // g)
    jb, pb = jnp.asarray(aabb), torch.from_numpy(aabb)
    if g > 1:
        jb, pb = jpt._coarse_aabb(jb, nc, g)[0], ppt._coarse_aabb(pb, nc, g)[0]
    jc = jnp.asarray(cap) if with_cap else None
    pc = torch.from_numpy(cap) if with_cap else None
    ja = jnp.asarray(act) if with_active else None
    pa = torch.from_numpy(act) if with_active else None
    js, jn = jpt._compact_src(_j(O), _j(d), jb, kn, jc, ja, 2048, R - 5)
    ps, pn = ppt._compact_src(_p(O), _p(d), pb, kn, pc, pa, 2048, R - 5)
    assert 0 < int(pn) == int(jn) < 2048
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


# ------------------------------------------------------------------- casts

@pytest.mark.parametrize("frac", [0.25, 0.05])
def test_direct_cast_parity(cat, rays, frac, monkeypatch):
    """Compacted B1, B3 and B2 casts (512-ray blocks) against the
    full-width ones, bitwise; at 0.05 the closest casts overflow their one
    tier and run at full width, the shadow cast compacts."""
    _, tab = cat
    O, d, _, act = rays
    O, u = _p(O), _p(d)
    cap = torch.full((R,), 1e9)
    seen = _tiers_taken(monkeypatch)
    for payload in ("geom", "smooth"):
        h0, n0 = ppt.intersect_tris_pairs(O, u, tab, 1e-4, cap=cap,
                                          payload=payload, blk=512)
        h1, n1 = ppt.intersect_tris_pairs(O, u, tab, 1e-4, cap=cap,
                                          payload=payload, blk=512,
                                          compact=frac)
        assert bool((h0.t < ppt.INF32).any())
        for a, b in zip((h0.t, h0.idx, *n0), (h1.t, h1.idx, *n1)):
            assert torch.equal(a, b), payload
    a = torch.from_numpy(act)
    t0 = ppt.intersect_tris_pairs_shadow(O, u, tab, 1e-4, cap=cap, active=a,
                                         blk=512)
    t1 = ppt.intersect_tris_pairs_shadow(O, u, tab, 1e-4, cap=cap, active=a,
                                         blk=512, compact=frac)
    assert torch.equal(t0[a], t1[a])
    taken = [C for _, _, C in seen]
    assert taken[2] > 0
    assert (taken[0] > 0) == (taken[1] > 0) == (frac == 0.25)


@pytest.mark.parametrize("frac", [0.25, 0.05])
def test_direct_cast_parity_within_cap(cat, rays, frac, monkeypatch):
    """With the seeded finite caps (0 to 40): on every lane whose
    full-width t is at most its cap (and is active, for B2) the
    compacted B1, B3 and B2 casts give the full-width results bitwise; on
    the others both give a t past the cap or INF."""
    _, tab = cat
    O, d, cap, act = rays
    O, u, cap, a = _p(O), _p(d), torch.from_numpy(cap), torch.from_numpy(act)
    seen = _tiers_taken(monkeypatch)

    def agree(t0, t1, rest0, rest1, lanes):
        inside = lanes & (t0 <= cap)
        assert int(inside.sum()) > 100
        for x, y in zip((t0, *rest0), (t1, *rest1)):
            assert torch.equal(x[inside], y[inside])
        rest = lanes & ~inside
        for t in (t0, t1):
            assert bool((t[rest] > cap[rest]).all())

    for payload in ("geom", "smooth"):
        h0, n0 = ppt.intersect_tris_pairs(O, u, tab, 1e-4, cap=cap,
                                          payload=payload, blk=512)
        h1, n1 = ppt.intersect_tris_pairs(O, u, tab, 1e-4, cap=cap,
                                          payload=payload, blk=512,
                                          compact=frac)
        agree(h0.t, h1.t, (h0.idx, *n0), (h1.idx, *n1),
              torch.ones_like(a))
    t0 = ppt.intersect_tris_pairs_shadow(O, u, tab, 1e-4, cap=cap, active=a,
                                         blk=512)
    t1 = ppt.intersect_tris_pairs_shadow(O, u, tab, 1e-4, cap=cap, active=a,
                                         blk=512, compact=frac)
    agree(t0, t1, (), (), a)
    # at 0.05 the closest casts overflow their 512-ray tier, the shadow
    # cast compacts
    assert [C for _, _, C in seen] == ([2048] * 3 if frac == 0.25
                                       else [0, 0, 512])


def test_coarse_key_boxes_are_built_once_a_table(cat, rays, monkeypatch):
    """The union boxes of a coarse key are built on a table's first cast
    and reused by the next, and the casts stay bitwise full width."""
    _, tab = cat
    O, d, _, _ = rays
    built = []
    coarse = ppt._coarse_aabb
    monkeypatch.setattr(ppt, "_coarse_aabb",
                        lambda *a: built.append(a[2]) or coarse(*a))
    kw = dict(blk=512, payload="geom")
    h0 = ppt.intersect_tris_pairs(_p(O), _p(d), tab, 1e-4, **kw)[0]
    for g in (4, 4, 8, 4):
        h1 = ppt.intersect_tris_pairs(_p(O), _p(d), tab, 1e-4, compact=0.25,
                                      key_coarse=g, **kw)[0]
        assert torch.equal(h0.t, h1.t) and torch.equal(h0.idx, h1.idx)
    assert built == [4, 8]


def test_overflowing_cast_sorts_nothing(cat, rays, monkeypatch):
    """The sort runs only on the tier that is taken: none on a cast that
    overflows every tier, one on a cast that compacts."""
    _, tab = cat
    O, d, _, _ = rays
    sorts = []
    sort = ppt._compact_sort
    monkeypatch.setattr(ppt, "_compact_sort",
                        lambda *a: sorts.append(a[1]) or sort(*a))
    seen = _tiers_taken(monkeypatch)
    kw = dict(blk=512, payload="geom")
    ppt.intersect_tris_pairs(_p(O), _p(d), tab, 1e-4, compact=0.05, **kw)
    assert seen[-1][2] == 0 and sorts == []
    ppt.intersect_tris_pairs(_p(O), _p(d), tab, 1e-4, compact=0.05,
                             compact2=0.25, **kw)
    assert sorts == [seen[-1][2]] == [2048]


# ------------------------------------------------------------------ frames

# tests/test_compact.py's configurations, but its d0 tier (the JAX
# package's pairs_compact_d0, which the port leaves out)
FRAME_CONFIGS = {
    "cmp25": dict(pairs_compact=0.25),
    "cmp_overflow": dict(pairs_compact=0.02),
    "ladder": dict(pairs_compact=0.02, pairs_compact2=0.25),
    "ladder_overflow": dict(pairs_compact=0.02, pairs_compact2=0.04),
    "ladder3": dict(pairs_compact=0.02, pairs_compact2=0.04,
                    pairs_compact3=0.5),
    "ladder3_overflow": dict(pairs_compact=0.02, pairs_compact2=0.03,
                             pairs_compact3=0.04),
    "sah_pave_cmp": dict(pairs_cluster="sah", pairs_pack="pave",
                         pairs_cut=32, pairs_compact=0.25),
    "key_coarse": dict(pairs_compact=0.25, pairs_key_coarse=4),
    "key_coarse_overflow": dict(pairs_compact=0.02, pairs_key_coarse=8),
    "all_depths": dict(pairs_compact_min_depth=0),
}


@pytest.fixture(scope="module")
def base():
    """The frame with every tier at 0: each cast at full width."""
    cfg, tables = build_preset("array_bvh", "cpu", **FRAME, **OFF)
    return render_preset_frame(tables, cfg, seed=0)


@pytest.mark.parametrize("name", ["default", *FRAME_CONFIGS])
def test_render_parity_with_overflow(base, name, monkeypatch):
    """Each configuration's frame and TraceStats are bitwise the base's.
    Past the default config, casts are padded to 128 rays (the frame does
    not depend on it), so that the tiers are fractions of the 4,608-ray
    casts and not of one 4,096-ray block."""
    seen = _tiers_taken(monkeypatch)
    over = ({} if name == "default"
            else dict(FRAME_CONFIGS[name], pairs_block=128))
    cfg, tables = build_preset("array_bvh", "cpu", **FRAME, **over)
    img, stats = render_preset_frame(tables, cfg, seed=0)
    assert np.isfinite(img).all()
    np.testing.assert_array_equal(img, base[0])
    for a, b in zip(stats, base[1]):
        np.testing.assert_array_equal(a, b)
    taken = [C for _, _, C in seen]
    keyed = 2 * (cfg.max_depth - (name != "all_depths"))
    assert len(taken) == keyed  # one key a cast at every keyed depth
    if name == "ladder3_overflow":
        assert not any(taken)   # every tier overflows: full width
    elif name == "ladder":
        assert all(C > t[0] for (t, _, _), C in zip(seen, taken))
    else:
        assert any(taken)


def test_default_frame_meets_the_jax_default_frame():
    """The port's default config against the JAX package's (every
    ``pairs_compact*`` field the same), 48x48 spp 2 depth 3, seed 0."""
    jcfg, jtab = j_build_preset("array_bvh", traversal="pairs", **FRAME)
    want = np.asarray(j_render_preset_frame(jtab, jcfg, seed=0)[0])
    cfg, tables = build_preset("array_bvh", "cpu", **FRAME)
    assert all(getattr(cfg, f) == getattr(jcfg, f) for f in LADDER)
    img = render_preset_frame(tables, cfg, seed=0)[0]
    bad = np.abs(img - want) > 1e-4 * np.abs(want) + 1.0
    assert bad.any(-1).mean() < 0.005


def test_the_dry_run_pairs_leg_compacts(monkeypatch):
    """The multichip dry run's pairs leg (pairs_compact 0.25, 128-ray
    blocks), at the half width tests/test_torch_sharding.py renders it on
    a (2, 2) mesh, runs compacted casts on one device and on a rank's
    rows and sample: its sharded frames hold the ladder."""
    seen = _tiers_taken(monkeypatch)
    cfg, tables = build_preset("array_bvh", "cpu", **dryrun_legs(shrink=2)[1])
    render_preset_frame(tables, cfg, seed=0)
    assert any(C for _, _, C in seen)
    seen.clear()
    render_rows(tables, cfg, Camera.default(cfg, "cpu"), PRNGKey(0, "cpu"),
                np.arange(cfg.height // 2, dtype=np.int32), [1])
    assert any(C for _, _, C in seen)


def test_ladder_bench_replays_a_frames_casts():
    """bench/ladder.py's machinery on the CPU: ``TierLog`` logs a frame's
    ladder casts by depth and query, and the casts ``capture_queries``
    keeps, run again through the public queries, take the tiers the frame
    took on the same active counts."""
    cfg, tables = build_preset("array_bvh", "cpu", **FRAME, pairs_block=128,
                               pairs_compact=0.25)
    cam = Camera.default(cfg, "cpu")
    frame = lambda: render_frame(tables, cfg, cam, PRNGKey(0, "cpu"))
    with ladder_bench.TierLog() as log:
        frame()
    assert [(e["depth"], e["query"]) for e in log.log] == [
        (d, q) for d in (1, 2) for q in ("closest", "shadow")]
    assert len(log.summary()) == 4
    kept = ladder_bench.capture_queries(frame, 6)
    assert [q for q, *_ in kept] == ["closest", "shadow"] * 3
    for (query, fn, a, k), want in zip(kept[2:], log.log):
        with ladder_bench.TierLog() as again:
            fn(*a, **k)
        (got,) = again.log
        assert (query, got["n"], got["C"]) == (want["query"], want["n"],
                                               want["C"])
        assert got["C"] > 0


# ---------------------------------------------------------- the config

def test_render_config_carries_the_jax_ladder():
    """The ladder's fields and defaults are the JAX package's, and
    ``render_config_from_dict`` carries them by name."""
    j, p = JRenderConfig(), RenderConfig()
    assert [getattr(p, f) for f in LADDER] == [getattr(j, f) for f in LADDER]
    assert [getattr(p, f) for f in LADDER] == [0.078125, 0.1328125, 0.1875,
                                               1, 1]
    d = dataclasses.asdict(dataclasses.replace(
        j, pairs_compact=0.25, pairs_compact2=0.0, pairs_compact3=0.5,
        pairs_key_coarse=4, pairs_compact_min_depth=2))
    conv = render_config_from_dict(d)
    assert [getattr(conv, f) for f in LADDER] == [d[f] for f in LADDER]


def test_render_config_drops_the_jax_d0_knobs():
    """The JAX package's d0 tier and subgroup (speed knobs of its depths
    below ``pairs_compact_min_depth``) have no field in the port: a JAX
    config that sets them converts to one whose depths below it run at
    full width."""
    j = dataclasses.replace(JRenderConfig(), pairs_compact_d0=0.3,
                            pairs_subgroup_d0=128)
    conv = render_config_from_dict(dataclasses.asdict(j))
    assert not any(hasattr(conv, f) for f in ("pairs_compact_d0",
                                              "pairs_subgroup_d0"))
    assert conv == RenderConfig()


@pytest.mark.parametrize("over,d0", [
    ({}, dict(pairs_compact=0.0, pairs_compact2=0.0, pairs_compact3=0.0)),
    (dict(pairs_compact_min_depth=0), None),
    (dict(pairs_compact=0.0), None),  # JAX: its scan, every depth at cfg
    (dict(pairs_compact=0.0, pairs_compact2=0.25), None),
    (dict(pairs_compact_min_depth=2),
     dict(pairs_compact=0.0, pairs_compact2=0.0, pairs_compact3=0.0)),
    (dict(traversal="pallas"), None)])
def test_depth_configs_follow_the_jax_policy(over, d0):
    """The JAX package's unrolled per-depth policy (its wavefront.trace)
    at its d0 defaults: depths below pairs_compact_min_depth run at full
    width, the others the config's ladder; when the policy does not apply
    (``pairs_compact`` 0 among them) every depth runs the config."""
    cfg, tables = build_preset("array_bvh", "cpu", width=8, height=8,
                               **over)
    got = depth_configs(tables, cfg, 4)
    mind = cfg.pairs_compact_min_depth
    if d0 is None:
        assert got == [cfg] * 4
    else:
        want0 = dataclasses.replace(cfg, **d0)
        assert got == [want0] * mind + [cfg] * (4 - mind)
