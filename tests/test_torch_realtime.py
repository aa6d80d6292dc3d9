"""The port's realtime loop against the JAX package's
(raytracinggpu_tpu_torch/render/realtime.py, utils/checkpoint.py, the
realtime camera of render/pipeline.py and the ``realtime`` preset).

Inputs are made from seeds and go through both packages on identical
tables (``scene_tables_from_numpy``).  Standards:

- the camera basis, the orbiting light and the quirk camera's primary
  rays: within 1e-6 absolute.  They are bitwise on most lanes; torch's
  and XLA's cos and sin differ in the last bit on about 1.3% of inputs,
  and XLA fuses the normalization of the quirk rays with the sums before
  it (measured: every basis component within 9e-8, ray directions within
  2e-7);
- the loop's state bookkeeping (frames, rng_frame, keys, camera keys,
  moved spheres, checkpoints): bitwise;
- frames: ``tests/test_golden.py``'s bound, fewer than 0.5% of pixels
  off by more than 1e-4*|g| + 1.0.  The uniforms are bitwise the JAX
  package's, so frames differ only where the last bits of a cast flip a
  path.  Measured: the 48x48 spp 2 depth 2 seed 0 frame is 1 pixel off
  the JAX ``pairs`` frame and 11 of 2,304 off the golden (the JAX frame
  itself is 10 off it); rows [256, 264) of the 512x512 view, 0 of 4,096
  off the JAX rows.  The 48x48 quirk view faces the back wall 5 units
  from the camera, so the 512x512 rows test the view the loop renders.
"""
import dataclasses
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytracinggpu_tpu.core.rng import box_muller_jitter as j_jitter
from raytracinggpu_tpu.core.vec import Vec3 as JV
from raytracinggpu_tpu.render import pipeline as jp
from raytracinggpu_tpu.render import realtime as jrt
from raytracinggpu_tpu.render.image_io import read_png
from raytracinggpu_tpu.scene.presets import build_preset as j_build_preset
from raytracinggpu_tpu.scene.presets import make_config as j_make_config
from raytracinggpu_tpu.scene.presets import wall_spheres as j_walls
from raytracinggpu_tpu.scene.scene import build_scene_tables as j_tables
from raytracinggpu_tpu.utils import checkpoint as jck
from raytracinggpu_tpu_torch.convert import (
    render_config_from_dict,
    render_state_from_numpy,
    scene_tables_from_numpy,
)
from raytracinggpu_tpu_torch.core.rng import PRNGKey, box_muller_terms
from raytracinggpu_tpu_torch.render import pipeline as pp
from raytracinggpu_tpu_torch.render import realtime as prt
from raytracinggpu_tpu_torch.render.image_io import tonemap
from raytracinggpu_tpu_torch.scene.presets import build_preset
from raytracinggpu_tpu_torch.utils import checkpoint as pck

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "realtime_48.npy")


def _frac_off(img, ref):
    bad = np.abs(img - ref) > 1e-4 * np.abs(ref) + 1.0
    return bad.any(-1).mean()


@pytest.fixture(scope="module")
def rt16():
    """The JAX package's 16x16 mesh-less realtime scene
    (tests/test_realtime.py) in both packages: (jcfg, jtab, pcfg, ptab)."""
    spheres, mats = j_walls(940.0)
    jcfg = j_make_config("realtime", mesh_object_id=-1, n_objects=6,
                         width=16, height=16, spp=2, max_depth=2)
    jtab = j_tables(spheres, mats, L=(0, 15, 40), intensity=3e10, mesh=None)
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    return jcfg, jtab, render_config_from_dict(dataclasses.asdict(jcfg)), ptab


def _state_np(state):
    """A port RenderState as a flat list of numpy leaves (JAX order)."""
    return ([t.numpy() for t in (state.accum, state.frames, state.rng_frame,
                                 state.light_angle, state.mesh_angle,
                                 *state.cam_c, state.yaw, state.pitch)]
            + [np.array([int(k) for k in state.key], np.uint32)])


def _assert_same_state(port, jax_state):
    for a, b in zip(_state_np(port), jax.tree.leaves(jax_state)):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ camera, light

@pytest.mark.parametrize("yaw,pitch", [(0.0, 0.3), (0.02, 0.3),
                                       (0.37, -0.2), (-1.1, 0.9)])
def test_from_yaw_pitch_matches_jax(yaw, pitch):
    cj = jax.jit(jp.Camera.from_yaw_pitch)(JV.const(1.0, -2.0, 53.0), yaw,
                                           pitch)
    cp = pp.Camera.from_yaw_pitch((1.0, -2.0, 53.0), yaw, pitch, "cpu")
    for vj, vp in zip(cj, cp):
        for a, b in zip(vj, vp):
            assert b.dtype == torch.float32 and b.dim() == 0
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)


def test_default_camera_is_the_reference_start():
    cfg = build_preset("realtime", "cpu", width=16, height=16)[0]
    cam = pp.Camera.default(cfg, "cpu")
    again = pp.Camera.from_yaw_pitch(cfg.camera_c, 0.0, 0.3, "cpu")
    for a, b in zip(cam, again):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    fixed = pp.Camera.default(dataclasses.replace(cfg,
                                                  camera_point_quirk=False),
                              "cpu")
    assert [float(c) for c in fixed.bz] == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("width", [48, 512])
def test_quirk_raygen_matches_jax(width):
    """Primary rays of the quirk camera (jitter, C + bz z + bx ux + by uy)
    from the same uniforms, the JAX side jitted as render_rows fuses it."""
    jcfg = j_make_config("realtime", width=width, height=width)
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    rows = np.arange(0, width, max(1, width // 32), dtype=np.int32)
    rng = np.random.default_rng(width)
    r1, r2 = (1.0 - rng.random((2, len(rows) * width))).astype(np.float32)
    jcam = jp.Camera.from_yaw_pitch(jcfg.camera_c, 0.1, 0.3)

    def jrays(r1, r2):
        gx, gy = j_jitter(r1, r2, np.float32(jcfg.sigma))
        return jp.raygen(jcfg, jcam, gx, gy, rows)

    Oj, uj = jax.jit(jrays)(r1, r2)
    pcam = pp.Camera.from_yaw_pitch(pcfg.camera_c, 0.1, 0.3, "cpu")
    jit = box_muller_terms(torch.from_numpy(r1), torch.from_numpy(r2),
                           pcfg.sigma)
    Op, up = pp.raygen(pcfg, pcam, jit, rows)
    for a, b in zip(Oj, Op):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(uj, up):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    if width == 512:  # at this width the quirk view looks into the box
        assert (np.asarray(uj.z) < 0).all()


def test_orbit_light_matches_jax(rt16):
    _, jtab, _, ptab = rt16
    first = np.float32(np.pi / 2) + np.float32(0.02)  # the loop's frame 1
    for angle in (0.0, 1.2345, first, -2.5):
        Lj = jrt.orbit_light(jtab, jnp.float32(angle)).L
        Lp = prt.orbit_light(ptab, np.float32(angle)).L
        for a, b in zip(Lj, Lp):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-5)  # |L| = 40
        assert float(Lp.y) == 15.0
        assert np.isclose(np.hypot(float(Lp.x), float(Lp.z)), 40.0,
                          rtol=1e-6)
        assert np.isclose(np.arctan2(float(Lp.z), float(Lp.x)),
                          np.arctan2(np.sin(angle), np.cos(angle)), atol=1e-6)


# ------------------------------------------------------------- state, loop

def test_init_state_matches_jax(rt16):
    jcfg, jtab, pcfg, ptab = rt16
    js = jrt.init_state(jcfg, jtab, seed=5)
    ps = prt.init_state(pcfg, ptab, seed=5)
    _assert_same_state(ps, js)
    conv = render_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    for a, b in zip(_state_np(conv), _state_np(ps)):
        np.testing.assert_array_equal(a, b)


def test_step_accumulates_and_display_is_tonemap_of_average(rt16):
    _, _, cfg, tables = rt16
    st = prt.init_state(cfg, tables, seed=0)
    # camera at the origin: the quirk direction would otherwise saturate
    # the whole 16-pixel view (as in tests/test_realtime.py)
    st = st._replace(cam_c=pp.Vec3.const(0.0, 0.0, 0.0, device="cpu"))
    st1, d1 = prt.step(tables, cfg, st)
    st2, d2 = prt.step(tables, cfg, st1)
    assert [int(st2.frames), int(st2.rng_frame)] == [2, 2]
    assert float(st2.light_angle) == float(np.float32(
        np.float32(st.light_angle.item() + np.float32(0.02))
        + np.float32(0.02)))
    a1, a2 = st1.accum.numpy(), st2.accum.numpy()
    assert (a2 >= a1).all() and a2.sum() > a1.sum()
    assert d2.dtype == torch.uint8 and d2.shape == (16, 16, 3)
    np.testing.assert_array_equal(d2.numpy(), tonemap(a2 / np.float32(2)))
    np.testing.assert_array_equal(d1.numpy(), tonemap(a1))
    assert not torch.equal(d1, d2)  # frames are decorrelated


def test_step_refuses_mesh_animation(rt16):
    """Mesh animation is ported (tests/test_torch_transform.py holds the
    animated loop); what ``step`` still refuses, as the JAX package's
    does, is to animate a scene without a mesh."""
    jcfg, jtab, cfg, tables = rt16
    animated = dataclasses.replace(cfg, animate_mesh=True)
    with pytest.raises(ValueError, match="no mesh"):
        prt.step(tables, animated, prt.init_state(cfg, tables))
    with pytest.raises(ValueError, match="no mesh"):
        jrt.step(jtab, dataclasses.replace(jcfg, animate_mesh=True),
                 jrt.init_state(jcfg, jtab))
    # with a mesh, the step advances the mesh angle by mesh_speed * dt
    mcfg, mtab = build_preset("realtime", "cpu", width=8, height=8, spp=1,
                              max_depth=1, traversal="bvh",
                              animate_mesh=True)
    st, _ = prt.step(mtab, mcfg, prt.init_state(mcfg, mtab), mesh_speed=2.0)
    assert float(st.mesh_angle) == float(np.float32(0.04))


def test_on_key_and_reset_accumulation_match_jax(rt16):
    jcfg, jtab, pcfg, ptab = rt16
    js = jrt.init_state(jcfg, jtab, seed=0)
    ps = prt.init_state(pcfg, ptab, seed=0)
    js, _ = jrt.step(jtab, jcfg, js)
    ps, _ = prt.step(ptab, pcfg, ps)
    assert int(ps.frames) == 1
    for key in ("left", "w", "up", "right", "down", "a", "d", "r", "f", "s",
                "left", "up"):
        js, ps = jrt.on_key(js, key), prt.on_key(ps, key)
        assert int(ps.frames) == 0 and float(ps.accum.abs().sum()) == 0.0
        for a, b in ((js.yaw, ps.yaw), (js.pitch, ps.pitch),
                     *zip(js.cam_c, ps.cam_c)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert np.isclose(float(ps.yaw), 0.02) and np.isclose(float(ps.pitch),
                                                          0.32)
    assert prt.on_key(ps, "q") is ps  # unknown key: no reset, no change
    st = prt.reset_accumulation(prt.step(ptab, pcfg, ps)[0])
    assert int(st.frames) == 0 and int(st.rng_frame) == 2
    assert float(st.accum.abs().sum()) == 0.0


def test_move_object_matches_jax(rt16):
    _, jtab, _, ptab = rt16
    sj = jrt.move_object(jtab, 1, (1.0, 2.0, -3.0), dt=0.5).spheres
    sp = prt.move_object(ptab, 1, (1.0, 2.0, -3.0), dt=0.5).spheres
    for f in ("cx", "cy", "cz", "radius"):
        np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                      np.asarray(getattr(sj, f)))
    assert float(sp.cy[1] - ptab.spheres.cy[1]) == 1.0
    assert torch.equal(sp.cx[::2], ptab.spheres.cx[::2])


def test_steps_bitwise_equals_repeated_step(rt16):
    _, _, cfg, tables = rt16
    st_a, frames = prt.steps(tables, cfg, 3, prt.init_state(cfg, tables, 4))
    st_b = prt.init_state(cfg, tables, 4)
    assert frames.shape == (3, 16, 16, 3)
    for i in range(3):
        st_b, disp = prt.step(tables, cfg, st_b)
        assert torch.equal(frames[i], disp)
    for a, b in zip(_state_np(st_a), _state_np(st_b)):
        np.testing.assert_array_equal(a, b)
    st_c, _ = prt.steps(tables, cfg, 2, prt.init_state(cfg, tables, 4),
                        reset_each=True)
    assert int(st_c.frames) == 0 and int(st_c.rng_frame) == 2


def test_run_loop_frames_per_dispatch_bitwise(rt16, tmp_path):
    """One frame or three frames per dispatch (with a remainder batch),
    pipelined or not: the same frames bit for bit, streamed in order."""
    _, _, cfg, tables = rt16
    runs = []
    for g, pipelined in ((1, True), (3, True), (3, False)):
        pipe = io.BytesIO()
        out = tmp_path / f"g{g}{pipelined}"
        st, summary = prt.run_loop(tables, cfg, n_frames=4, out_dir=str(out),
                                   raw_pipe=pipe, print_every=0,
                                   frames_per_dispatch=g, pipelined=pipelined)
        assert int(st.frames) == 4 and summary["frames"] == 4
        assert summary["fps"] > 0 and summary["mean_ms"] > 0
        raw = np.frombuffer(pipe.getvalue(), np.uint8).reshape(4, 16, 16, 3)
        assert sorted(os.listdir(out)) == [f"frame_{i:05d}.png"
                                           for i in range(4)]
        for i in range(4):
            np.testing.assert_array_equal(
                read_png(str(out / f"frame_{i:05d}.png")), raw[i])
        runs.append(raw)
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0], runs[2])
    _, disp = prt.steps(tables, cfg, 4, prt.init_state(cfg, tables, 0))
    np.testing.assert_array_equal(runs[0], disp.numpy())


# ------------------------------------------------------------- checkpoints

def test_checkpoint_resume_bitwise(rt16, tmp_path):
    _, _, cfg, tables = rt16
    st = prt.init_state(cfg, tables, seed=3)
    for _ in range(2):
        st, _ = prt.step(tables, cfg, st)
    p = str(tmp_path / "ckpt.npz")
    pck.save_state(p, st)
    resumed = pck.load_state(p, "cpu")
    for a, b in zip(_state_np(resumed), _state_np(st)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    a, disp_a = prt.step(tables, cfg, resumed)
    b, disp_b = prt.step(tables, cfg, st)
    assert torch.equal(disp_a, disp_b) and torch.equal(a.accum, b.accum)
    assert int(a.frames) == int(b.frames) == 3


def test_checkpoint_loads_the_older_layout(rt16, tmp_path):
    """A 10-leaf checkpoint (saved before the state had mesh_angle) loads
    with mesh_angle 0; any other leaf count is refused."""
    _, _, cfg, tables = rt16
    leaves = _state_np(prt.init_state(cfg, tables, seed=3))
    old = leaves[:4] + leaves[5:]
    path = str(tmp_path / "old.npz")
    np.savez(path, *old, treedef="legacy", n_leaves=len(old))
    restored = pck.load_state(path, "cpu")
    assert float(restored.mesh_angle) == 0.0
    for a, b in zip(_state_np(restored), leaves):
        np.testing.assert_array_equal(a, b)
    bad = str(tmp_path / "bad.npz")
    np.savez(bad, *old[:9], treedef="?", n_leaves=9)
    with pytest.raises(ValueError):
        pck.load_state(bad, "cpu")


def test_jax_checkpoint_resumes_in_port(rt16, tmp_path):
    """The JAX loop saves after two frames; the port loads the file and
    renders the third frame, which the JAX loop renders too."""
    jcfg, jtab, pcfg, ptab = rt16
    js = jrt.init_state(jcfg, jtab, seed=3)
    for _ in range(2):
        js, _ = jrt.step(jtab, jcfg, js)
    path = str(tmp_path / "jax.npz")
    jck.save_state(path, js)
    ps = pck.load_state(path, "cpu")
    _assert_same_state(ps, js)
    ps3, pdisp = prt.step(ptab, pcfg, ps)
    js3, jdisp = jrt.step(jtab, jcfg, js)
    assert int(ps3.frames) == 3 and int(ps3.rng_frame) == 3
    np.testing.assert_allclose(ps3.light_angle.numpy(),
                               np.asarray(js3.light_angle), rtol=1e-7)
    assert _frac_off(ps3.accum.numpy() / 3, np.asarray(js3.accum) / 3) < 0.005
    assert (np.abs(pdisp.numpy().astype(int)
                   - np.asarray(jdisp).astype(int)) <= 1).mean() > 0.99
    # and the port's own checkpoint loads in the JAX package
    pck.save_state(path, ps3)
    back = jck.load_state(path)
    _assert_same_state(ps3, back)


# ------------------------------------------------------------------ frames

def test_realtime_48_frame_matches_golden_and_jax():
    size = dict(width=48, height=48, spp=2, max_depth=2)
    cfg, tables = build_preset("realtime", "cpu", **size)
    img, stats = pp.render_preset_frame(tables, cfg, seed=0)
    assert np.isfinite(img).all()
    assert stats.hit.tolist() == [48 * 48 * 2] * 2  # the box is closed
    assert _frac_off(img, np.load(GOLDEN)) < 0.005
    jcfg, jtab = j_build_preset("realtime", traversal="pairs", **size)
    jimg, _ = jp.render_preset_frame(jtab, jcfg, seed=0)
    assert _frac_off(img, jimg) < 0.005


def test_realtime_512_view_rows_match_jax():
    """Rows [256, 264) of the 512x512 realtime view, spp 2, depth 2, seed
    0, through render_rows of both packages: the view the loop renders,
    into the box and onto the cat."""
    size = dict(width=512, height=512, spp=2, max_depth=2)
    rows = np.arange(256, 264, dtype=np.int32)
    jcfg, jtab = j_build_preset("realtime", traversal="pairs", **size)
    acc, _ = jax.jit(jp.render_rows, static_argnums=1)(
        jtab, jcfg, jp.Camera.default(jcfg), jax.random.PRNGKey(0), rows,
        np.arange(2))
    jimg = np.stack([np.asarray(c).reshape(8, 512) for c in acc], -1) / 2
    ptab = scene_tables_from_numpy(jax.tree.map(np.asarray, jtab), "cpu")
    pcfg = render_config_from_dict(dataclasses.asdict(jcfg))
    acc, stats = pp.render_rows(ptab, pcfg, pp.Camera.default(pcfg, "cpu"),
                                PRNGKey(0, "cpu"), rows, range(2))
    img = np.stack([c.numpy().reshape(8, 512) for c in acc], -1) / 2
    assert stats.hit.tolist() == [8 * 512 * 2] * 2  # the box is closed
    assert int(stats.shadowed.sum()) > 0
    assert _frac_off(img, jimg) < 0.005
