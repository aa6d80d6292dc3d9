"""The port's mesh poses (raytracinggpu_tpu_torch/scene/transform.py) and
the animated realtime loop, against the port's own host builds and the
JAX package's ``pose_mesh``.

Standards:

- an identity pose reproduces the host-built triangle, tiled and pairs
  tables and the BVH boxes bit for bit (the pose rounds every product
  and sum of the table build as the numpy build does);
- against the JAX package, both packages pose with the JAX matrix M
  (passed in as numpy: the port's cos and sin equal XLA:CPU's on most
  angles, not all).  The posed vertices round as XLA:CPU fuses them, so
  every box (tiled and pairs tiles, pairs members, BVH nodes) is bitwise
  the JAX package's; the fields and the feature matrix, which XLA:CPU
  computes with fused multiply-adds, agree within rtol 1e-5 + atol 1e-5
  (measured: 82 to 95% of the entries bitwise, at most 7.7e-6 apart);
- boxes contain the rotated vertices (tests/test_transform.py);
- a posed render against a render of host-rotated vertices: at least 98%
  of pixels within one u8 level (tests/test_transform.py's standard: the
  trees differ, so last-bit tie-breaks may flip a path);
- the animated loop: bitwise between ``steps`` and repeated ``step``,
  across ``frames_per_dispatch`` and across a checkpoint resume; against
  the JAX ``step`` on the same converted tables and state the state's
  angles bitwise, and the frame under the posed-render standard above
  with its mean within the anchors' 1%.  The frame is two roundings of
  one posed geometry (the port's fields round as its host build, the JAX
  package's as XLA fuses them; the JAX package's own pose is no more
  bitwise its host build), seen from 3 units off the cat: measured at
  the first frame, 7 of 1,024 pixels outside tests/test_golden.py's
  bound (2 when the port renders the JAX-posed tables, 2 unanimated),
  the mean 0.47% apart.
"""
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.render import realtime as jrt
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu.scene.transform import pose_mesh as j_pose
from raytracinggpu_tpu.scene.transform import rotation_y as j_rotation_y
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    render_state_from_numpy,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pallas_trace import TILE_T
from raytracinggpu_tpu_torch.render import realtime as rt
from raytracinggpu_tpu_torch.render.image_io import tonemap
from raytracinggpu_tpu_torch.render.pipeline import render_preset_frame
from raytracinggpu_tpu_torch.scene.mesh import build_mesh, rescale, rotate_y
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
from raytracinggpu_tpu_torch.scene.presets import build_preset
from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y
from raytracinggpu_tpu_torch.utils import checkpoint as pck

torch.set_num_threads(2)

SIZE = dict(width=32, height=32, spp=2, max_depth=2)
# a 32x32 view of the quirk camera that sees the cat (at widths below
# about 120 the default position looks at the back wall)
RT_SIZE = dict(width=32, height=32, spp=2, max_depth=2)
RT_CAM = (0.0, -5.0, 8.0)
MESH_SPEED = 45.0   # 0.9 rad a frame at dt = 0.02


@pytest.fixture(scope="module")
def scene():
    return build_preset("array_bvh", "cpu", traversal="pallas", **SIZE)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _bitwise(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def _rot(ang):
    c, s = np.cos(ang), np.sin(ang)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _corners(v: Vec3):
    return np.stack([c.numpy() for c in v], axis=1)


def test_identity_pose_is_noop(scene):
    """Every posed table equals the host-built one bit for bit."""
    _, tab = scene
    posed = pose_mesh(tab, rotation_y(0.0))
    _bitwise(posed.mesh.mt, tab.mesh.mt)
    _bitwise(posed.mesh.cornersT, tab.mesh.cornersT)
    for a, b in zip((*posed.mesh.ng, *posed.mesh.na),
                    (*tab.mesh.ng, *tab.mesh.na)):
        _bitwise(a, b)
    for f in ("fields", "fieldsT", "tile_aabb"):
        _bitwise(getattr(posed.pallas_mesh, f), getattr(tab.pallas_mesh, f))
    for f in ("fields", "tile_aabb", "member_aabb", "slot_src"):
        _bitwise(getattr(posed.pairs_mesh, f), getattr(tab.pairs_mesh, f))
    for a, b in zip((*posed.bvh.mn, *posed.bvh.mx),
                    (*tab.bvh.mn, *tab.bvh.mx)):
        _bitwise(a, b)


@pytest.mark.parametrize("ang", [0.7, -np.pi / 3])
def test_posed_tables_match_jax(ang):
    _, jt = j_build_preset("array_bvh", width=8, height=8, spp=1,
                           max_depth=1)
    pt = scene_tables_from_numpy(jax.tree.map(np.asarray, jt), "cpu")
    M = np.asarray(jax.jit(j_rotation_y)(jnp.float32(ang)))
    t = (1.0, 2.0, -3.0)
    jp = jax.tree.map(np.asarray, jax.jit(
        lambda s, M: j_pose(s, M, t))(jt, jnp.asarray(M)))
    pp = pose_mesh(pt, M, t)
    for a, b in ((jp.pallas_mesh.tile_aabb, pp.pallas_mesh.tile_aabb),
                 (jp.pairs_mesh.tile_aabb, pp.pairs_mesh.tile_aabb),
                 (jp.pairs_mesh.member_aabb, pp.pairs_mesh.member_aabb),
                 *zip((*jp.bvh.mn, *jp.bvh.mx), (*pp.bvh.mn, *pp.bvh.mx))):
        _bitwise(b, a)
    for a, b in ((jp.pallas_mesh.fields, pp.pallas_mesh.fields),
                 (jp.mesh.mt, pp.mesh.mt),
                 (jp.mesh.cornersT, pp.mesh.cornersT),
                 (jp.pairs_mesh.fields, pp.pairs_mesh.fields)):
        np.testing.assert_allclose(b.numpy(), a, rtol=1e-5, atol=1e-5)


def test_rotation_matches_jax_to_an_ulp():
    for ang in np.linspace(-3.0, 3.0, 13, dtype=np.float32):
        a = np.asarray(j_rotation_y(jnp.float32(ang)))
        b = rotation_y(ang).numpy()
        assert b.dtype == np.float32 and b.shape == (3, 3)
        np.testing.assert_allclose(b, a, rtol=0, atol=1.2e-7)


def test_tile_aabbs_contain_rotated_vertices(scene):
    _, tab = scene
    ang = 0.7
    posed = pose_mesh(tab, rotation_y(ang))
    aabb = posed.pallas_mesh.tile_aabb.numpy()
    valid = tab.mesh_src.valid.numpy()
    for corner in (tab.mesh_src.A, tab.mesh_src.B, tab.mesh_src.C):
        v = _corners(corner) @ _rot(ang).T
        for j in range(aabb.shape[0]):
            sl = slice(j * TILE_T, (j + 1) * TILE_T)
            if not valid[sl].any():
                continue
            pts = v[sl][valid[sl]]
            assert (pts >= aabb[j, 0:3] - 1e-4).all()
            assert (pts <= aabb[j, 3:6] + 1e-4).all()


def test_bvh_boxes_contain_rotated_triangles(scene):
    """Every node box (the root as in tests/test_transform.py, and each
    node's own triangles) contains the rotated vertices."""
    _, tab = scene
    ang = -np.pi / 3   # the reference's intended pose
    posed = pose_mesh(tab, rotation_y(ang))
    mn = _corners(posed.bvh.mn)
    mx = _corners(posed.bvh.mx)
    s, e = posed.bvh.tri_start.numpy(), posed.bvh.tri_end.numpy()
    for corner in (tab.mesh_src.A, tab.mesh_src.B, tab.mesh_src.C):
        v = _corners(corner) @ _rot(ang).T
        for i in range(mn.shape[0]):
            pts = v[s[i]:e[i]]
            assert (pts >= mn[i] - 1e-3).all() and (pts <= mx[i] + 1e-3).all()


def test_member_boxes_contain_rotated_vertices(scene):
    _, tab = scene
    ang = 0.7
    pm = pose_mesh(tab, rotation_y(ang)).pairs_mesh
    slot_src = pm.slot_src.numpy()
    m_slot = pm.member_slot.numpy()
    aabb = pm.member_aabb.numpy()
    live = slot_src >= 0
    for corner in (tab.mesh_src.A, tab.mesh_src.B, tab.mesh_src.C):
        pts = (_corners(corner) @ _rot(ang).T)[slot_src[live]]
        m = m_slot[live]
        assert (pts >= aabb[m, 0:3] - 1e-3).all()
        assert (pts <= aabb[m, 3:6] + 1e-3).all()


@pytest.fixture(scope="module")
def host_rotated():
    """The cat rotated by 0.9 on the host before its BVH build."""
    obj = read_obj(CAT_OBJ_PATH)
    obj.vertices = rotate_y(rescale(obj.vertices, 0.6, (0.0, -10.0, 0.0)),
                            0.9)
    return build_mesh(obj)


@pytest.mark.parametrize("traversal", ["pallas", "dense", "pairs", "bvh"])
def test_rotated_render_matches_host_rebuild(host_rotated, traversal):
    cfg, tab = build_preset("array_bvh", "cpu", traversal=traversal, **SIZE)
    img_dev, _ = render_preset_frame(pose_mesh(tab, rotation_y(0.9)), cfg)
    cfg2, tab2 = build_preset("array_bvh", "cpu", mesh=host_rotated,
                              traversal=traversal, **SIZE)
    img_host, _ = render_preset_frame(tab2, cfg2)
    d = np.abs(tonemap(img_dev).astype(int) - tonemap(img_host).astype(int))
    assert (d.max(axis=-1) <= 1).mean() > 0.98


def test_pose_composes_with_translation(scene):
    _, tab = scene
    posed = pose_mesh(tab, rotation_y(0.0), t=(3.0, 0.0, 0.0))
    a0 = tab.pallas_mesh.tile_aabb.numpy()
    a1 = posed.pallas_mesh.tile_aabb.numpy()
    live = a0[:, 0] < 1e9
    np.testing.assert_allclose(a1[live, 0], a0[live, 0] + 3.0, atol=1e-4)
    np.testing.assert_allclose(a1[live, 1], a0[live, 1], atol=1e-4)
    np.testing.assert_allclose(posed.bvh.mn.x.numpy(),
                               tab.bvh.mn.x.numpy() + 3.0, atol=1e-4)


def test_pose_needs_a_mesh():
    _, tab = build_preset("showcase", "cpu", width=8, height=8, spp=1,
                          max_depth=1)
    with pytest.raises(ValueError, match="no mesh"):
        pose_mesh(tab, rotation_y(0.5))


def test_pose_skips_refused_pairs_tables(scene):
    _, tab = scene
    posed = pose_mesh(tab._replace(pairs_mesh=None), rotation_y(0.3))
    assert posed.pairs_mesh is None and posed.mesh is not None


# ------------------------------------------------------------ animated loop

@pytest.fixture(scope="module")
def animated():
    """The animated realtime scene through ``bvh``, the fastest traversal
    on the CPU (the loop's bookkeeping does not depend on it; every pose
    rebuilds every table)."""
    return build_preset("realtime", "cpu", traversal="bvh",
                        animate_mesh=True, **RT_SIZE)


def _advance(angle):
    """angle + MESH_SPEED * dt rounded once, as the loop advances it."""
    step = np.float64(np.float32(MESH_SPEED)) * np.float64(np.float32(0.02))
    return float(np.float32(np.float64(np.float32(angle)) + step))


def _start(cfg, tab):
    st = rt.init_state(cfg, tab, seed=0)
    return st._replace(cam_c=Vec3.const(*RT_CAM, device="cpu"))


def test_realtime_animated_mesh():
    """tests/test_transform.py's case, through ``pallas`` as there: the
    mesh angle advances by mesh_speed * dt a frame, the frames differ,
    equal seeds repeat."""
    cfg, tab = build_preset("realtime", "cpu", traversal="pallas",
                            animate_mesh=True, **RT_SIZE)
    st = _start(cfg, tab)
    st1, d1 = rt.step(tab, cfg, st, mesh_speed=MESH_SPEED)
    st2, _ = rt.step(tab, cfg, st1, mesh_speed=MESH_SPEED)
    a1 = _advance(0.0)
    assert float(st1.mesh_angle) == a1
    assert float(st2.mesh_angle) == _advance(a1) > a1
    assert not torch.equal(st2.accum, 2.0 * st1.accum)
    _, d1b = rt.step(tab, cfg, _start(cfg, tab), mesh_speed=MESH_SPEED)
    assert torch.equal(d1, d1b)
    # the pose is the frame's: frame 1 equals a still render of the
    # scene posed at frame 1's angle
    still = dataclasses.replace(cfg, animate_mesh=False)
    posed = pose_mesh(tab, rotation_y(st1.mesh_angle))
    s1, _ = rt.step(posed, still, st, mesh_speed=MESH_SPEED)
    assert torch.equal(s1.accum, st1.accum)
    unposed, _ = rt.step(tab, still, st)
    assert not torch.equal(unposed.accum, st1.accum)


def test_animated_steps_bitwise_equals_repeated_step(animated):
    cfg, tab = animated
    a, da = rt.steps(tab, cfg, 3, _start(cfg, tab), mesh_speed=MESH_SPEED)
    b = _start(cfg, tab)
    for i in range(3):
        b, d = rt.step(tab, cfg, b, mesh_speed=MESH_SPEED)
        assert torch.equal(d, da[i])
    assert torch.equal(a.accum, b.accum)
    assert torch.equal(a.mesh_angle, b.mesh_angle)


def test_animated_run_loop_frames_per_dispatch_bitwise(animated,
                                                       monkeypatch):
    cfg, tab = animated
    init = rt.init_state
    monkeypatch.setattr(rt, "init_state", lambda c, s, seed=0: init(
        c, s, seed)._replace(cam_c=Vec3.const(*RT_CAM, device="cpu")))
    out = {}
    for g in (1, 2):
        pipe = io.BytesIO()
        st, summary = rt.run_loop(tab, cfg, 3, raw_pipe=pipe, print_every=0,
                                  mesh_speed=MESH_SPEED,
                                  frames_per_dispatch=g)
        out[g] = (st, pipe.getvalue())
        assert summary["frames"] == 3
    assert out[1][1] == out[2][1]
    assert torch.equal(out[1][0].accum, out[2][0].accum)
    assert float(out[1][0].mesh_angle) > 2.0


def test_animated_checkpoint_resume_bitwise(animated, tmp_path):
    cfg, tab = animated
    st = _start(cfg, tab)
    for _ in range(2):
        st, _ = rt.step(tab, cfg, st, mesh_speed=MESH_SPEED)
    path = str(tmp_path / "anim.npz")
    pck.save_state(path, st)
    resumed = pck.load_state(path, "cpu")
    assert torch.equal(resumed.mesh_angle, st.mesh_angle)
    a, da = rt.step(tab, cfg, resumed, mesh_speed=MESH_SPEED)
    b, db = rt.step(tab, cfg, st, mesh_speed=MESH_SPEED)
    assert torch.equal(da, db) and torch.equal(a.accum, b.accum)
    assert torch.equal(a.mesh_angle, b.mesh_angle)


def test_animated_step_matches_jax():
    """The JAX step and the port's on the same converted tables and state
    (the dense traversal, whose JAX form runs without interpret mode)."""
    jcfg, jtab = j_build_preset("realtime", traversal="dense",
                                animate_mesh=True, **RT_SIZE)
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    assert pcfg.animate_mesh and pcfg.traversal == "dense"
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    js = jrt.init_state(jcfg, jtab, seed=0)
    js = js._replace(cam_c=type(js.cam_c)(*(jnp.float32(c) for c in RT_CAM)))
    ps = render_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    speed = (np.float32(1.0), np.float32(0.02), np.float32(MESH_SPEED))
    for _ in range(2):
        js, jd = jrt.step(jtab, jcfg, js, *speed)
        ps, pd = rt.step(ptab, pcfg, ps, *speed)
        for f in ("mesh_angle", "light_angle", "frames", "rng_frame"):
            _bitwise(getattr(ps, f), np.asarray(getattr(js, f)))
        d = np.abs(pd.numpy().astype(int) - np.asarray(jd).astype(int))
        assert (d.max(axis=-1) <= 1).mean() > 0.98
        g = float(np.asarray(js.accum).astype(np.float64).mean())
        assert abs(float(ps.accum.double().mean()) - g) <= 0.01 * g
