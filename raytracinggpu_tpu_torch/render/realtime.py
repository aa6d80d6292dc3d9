"""Progressive / realtime rendering loop (port of
``raytracinggpu_tpu/render/realtime.py``).

The reference's interactive renderer (realtime_render.cu) becomes a
``step`` on a render state of device tensors; frames stream to the host as
uint8 RGB (PNG sequence or raw pipe).

- progressive accumulation ``accum += frame; display = accum / frames``
  with the gamma pack of ``tonemap``;
- per-frame decorrelation: frame n draws with ``fold_in(key, rng_frame)``,
  and ``rng_frame`` is never reset, so clearing the accumulator does not
  replay samples;
- the point light orbits the Y axis through the origin, ``angular_speed *
  dt`` radians a frame;
- with ``cfg.animate_mesh`` the mesh spins about the Y axis,
  ``mesh_speed * dt`` radians a frame: every frame poses the scene's
  base geometry on the device (``scene/transform.pose_mesh``) before it
  renders;
- the camera: yaw/pitch +-0.02 on the arrows, +-2 translation on
  a/d/r/f/w/s, any recognized key resetting the accumulation;
- spp and depth from the config (20 and 3 for the ``realtime`` preset).

The state, ``mesh_angle`` included, is serializable
(``utils/checkpoint.py``) in the JAX package's layout.
"""
from __future__ import annotations

import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.rng import Key, PRNGKey, fold_in
from raytracinggpu_tpu_torch.core.vec import Vec3, cos, fma, sin, sqrt
from raytracinggpu_tpu_torch.render.image_io import tonemap_device, write_png
from raytracinggpu_tpu_torch.render.pipeline import Camera, render_rows
from raytracinggpu_tpu_torch.scene.scene import RenderConfig, SceneTables
from raytracinggpu_tpu_torch.scene.transform import pose_mesh, rotation_y
from raytracinggpu_tpu_torch.utils.profiling import request, span

YAW_PITCH_STEP = 0.02   # realtime_render.cu arrow keys
MOVE_STEP = 2.0         # realtime_render.cu a/d/r/f/w/s


class RenderState(NamedTuple):
    """Everything the progressive loop carries between frames; every
    leaf a tensor on the render device."""

    accum: torch.Tensor        # (H, W, 3) f32 radiance sum
    frames: torch.Tensor       # () int32, accumulated frames
    rng_frame: torch.Tensor    # () int32, monotonic frame index for the RNG
    light_angle: torch.Tensor  # () f32, orbit angle of L
    mesh_angle: torch.Tensor   # () f32, mesh pose angle (animate_mesh)
    cam_c: Vec3                # camera position, 0-d f32 components
    yaw: torch.Tensor          # () f32
    pitch: torch.Tensor        # () f32
    key: Key                   # base threefry key


def _scalar(v, dtype, device):
    return torch.tensor(v, dtype=dtype, device=device)


def init_state(cfg: RenderConfig, scene: SceneTables, seed: int = 0
               ) -> RenderState:
    """The reference's start: camera at cfg.camera_c, yaw 0, pitch 0.3;
    the light at its preset position, as an orbit angle."""
    dev = scene.device
    angle = float(np.arctan2(float(scene.L.z), float(scene.L.x)))
    f32 = lambda v: _scalar(np.float32(v), torch.float32, dev)
    return RenderState(
        accum=torch.zeros((cfg.height, cfg.width, 3), device=dev),
        frames=_scalar(0, torch.int32, dev),
        rng_frame=_scalar(0, torch.int32, dev),
        light_angle=f32(angle),
        mesh_angle=f32(0.0),
        cam_c=Vec3.const(*cfg.camera_c, device=dev),
        yaw=f32(0.0),
        pitch=f32(0.3),
        key=PRNGKey(seed, dev),
    )


def orbit_light(scene: SceneTables, angle) -> SceneTables:
    """The light on its Y-axis orbit (MoveLightSource): the xz radius and
    the height L.y kept, at ``angle`` (radians, f32)."""
    L = scene.L
    r = sqrt(fma(L.x, L.x, L.z * L.z))
    angle = torch.as_tensor(angle, dtype=torch.float32, device=scene.device)
    return scene._replace(L=Vec3(r * cos(angle), L.y, r * sin(angle)))


def step(scene: SceneTables, cfg: RenderConfig, state: RenderState,
         angular_speed=1.0, dt=2e-2, mesh_speed=1.0):
    """One progressive frame: orbit the light (and, with
    cfg.animate_mesh, advance the mesh angle and pose the mesh), render
    cfg.spp samples, accumulate, and make the gamma-packed display.
    Returns (new_state, display (H, W, 3) uint8 on the device).  Each
    angle advances as XLA:CPU rounds the JAX package's ``angle + speed *
    dt``: one fused multiply-add."""
    with request("step"):
        dev = state.accum.device
        angle = fma(np.float32(angular_speed), np.float32(dt),
                    state.light_angle)
        scene_t = orbit_light(scene, angle)
        mesh_angle = state.mesh_angle
        if cfg.animate_mesh:
            mesh_angle = fma(np.float32(mesh_speed), np.float32(dt),
                             mesh_angle)
            scene_t = pose_mesh(scene_t, rotation_y(mesh_angle))
        cam = Camera.from_yaw_pitch(state.cam_c, state.yaw, state.pitch, dev)
        rows = np.arange(cfg.height, dtype=np.int32)
        acc, _ = render_rows(scene_t, cfg, cam,
                             fold_in(state.key, state.rng_frame), rows,
                             range(cfg.spp))
        with span("step.accumulate_tonemap"):
            frame = torch.stack([(c / float(cfg.spp))
                                 .reshape(cfg.height, cfg.width)
                                 for c in acc], dim=-1)
            accum = state.accum + frame
            frames = state.frames + 1
            display = tonemap_device(accum / frames.to(torch.float32))
        new_state = state._replace(accum=accum, frames=frames,
                                   rng_frame=state.rng_frame + 1,
                                   light_angle=angle, mesh_angle=mesh_angle)
    return new_state, display


def steps(scene: SceneTables, cfg: RenderConfig, n_frames: int,
          state: RenderState, angular_speed=1.0, dt=2e-2,
          reset_each: bool = False, mesh_speed=1.0):
    """n_frames progressive frames in a row.  reset_each clears the
    accumulator after every frame (a crisp animation of the moving light).
    Returns (state, displays (n, H, W, 3) uint8)."""
    displays = []
    for _ in range(n_frames):
        state, disp = step(scene, cfg, state, angular_speed, dt, mesh_speed)
        if reset_each:
            state = reset_accumulation(state)
        displays.append(disp)
    return state, torch.stack(displays)


def move_object(scene: SceneTables, index: int, delta,
                dt: float = 0.2) -> SceneTables:
    """Translate sphere ``index`` by delta*dt (MoveObject).  Callers reset
    the accumulation afterwards, as after any scene edit."""
    d = np.asarray(delta, np.float32) * np.float32(dt)
    sp = scene.spheres
    sel = torch.arange(sp.cx.shape[0], device=sp.cx.device) == index
    moved = [c + torch.where(sel, float(dc), 0.0)
             for c, dc in zip((sp.cx, sp.cy, sp.cz), d)]
    return scene._replace(spheres=sp._replace(cx=moved[0], cy=moved[1],
                                              cz=moved[2]))


def reset_accumulation(state: RenderState) -> RenderState:
    """buffer_reset: clear the accumulator and restart the frame count."""
    return state._replace(accum=torch.zeros_like(state.accum),
                          frames=torch.zeros_like(state.frames))


def on_key(state: RenderState, keyname: str) -> RenderState:
    """Apply one key event; unknown keys return the state unchanged.
    left/right change yaw by +-0.02, up/down pitch by +-0.02; a/d move x,
    r/f y and w/s z by -/+2 (r is +y, w is -z).  Every recognized key
    resets the accumulation."""
    c = state.cam_c
    angles = {"left": ("yaw", 1), "right": ("yaw", -1),
              "up": ("pitch", 1), "down": ("pitch", -1)}
    moves = {"a": (0, -1), "d": (0, 1), "r": (1, 1), "f": (1, -1),
             "w": (2, -1), "s": (2, 1)}
    if keyname in angles:
        name, sign = angles[keyname]
        upd = {name: getattr(state, name) + sign * YAW_PITCH_STEP}
    elif keyname in moves:
        axis, sign = moves[keyname]
        upd = {"cam_c": c._replace(**{"xyz"[axis]: c[axis] + sign * MOVE_STEP})}
    else:
        return state
    return reset_accumulation(state._replace(**upd))


def _fetch(display: torch.Tensor):
    """Start copying a display batch to the host; returns a handle for
    ``_ready``.  On the card the copy goes to pinned memory behind the
    frame's kernels, so the host can enqueue the next frame meanwhile."""
    if not display.is_cuda:
        return display, None
    host = torch.empty(display.shape, dtype=display.dtype, pin_memory=True)
    host.copy_(display, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _ready(handle) -> np.ndarray:
    host, done = handle
    if done is not None:
        done.synchronize()
    return host.numpy()


def run_loop(scene: SceneTables, cfg: RenderConfig, n_frames: int,
             seed: int = 0, out_dir: str | None = None, raw_pipe=None,
             print_every: int = 5, angular_speed: float = 1.0,
             mesh_speed: float = 1.0, pipelined: bool = True,
             frames_per_dispatch: int = 1):
    """Host frame pump: steps the renderer, streams frames (PNGs into
    ``out_dir``, raw RGB24 bytes to ``raw_pipe``) and prints the frame time
    every ``print_every`` frames.

    pipelined (default): enqueue frame n+1 before reading frame n back, so
    the card renders one frame while the host enqueues the next; frames
    stream in order, one frame late.  pipelined=False waits for each frame
    before enqueuing the next.

    frames_per_dispatch (g): enqueue g frames before reading any of them
    back; the frames are bitwise those of g = 1.

    Returns (final_state, {"frames", "mean_ms", "fps", "p95_ms",
    "first_frame_ms"}) over every frame's interval on the host clock: from
    the arrival of the display before it (the first frame's from the
    loop's start) to its own, the PNG and pipe writes between them left
    out; the displays of one dispatch arrive together and share its
    interval evenly.  ``mean_ms`` and ``fps`` are the loop's own rate."""
    state = init_state(cfg, scene, seed)
    times: list[float] = []
    g = max(1, int(frames_per_dispatch))

    def emit(i0, displays):
        for j, display in enumerate(displays):
            i = i0 + j
            if out_dir is not None:
                os.makedirs(out_dir, exist_ok=True)
                write_png(os.path.join(out_dir, f"frame_{i:05d}.png"),
                          display)
            if raw_pipe is not None:
                raw_pipe.write(display.tobytes())
            if print_every and (i + 1) % print_every == 0:
                # never interleave text with a raw RGB24 stdout stream
                print(f"frame {i + 1}: {times[-1] * 1e3:.1f} ms "
                      f"({1.0 / times[-1]:.1f} FPS)",
                      file=sys.stderr if raw_pipe is not None else sys.stdout)

    last = time.perf_counter()  # the last arrival, after its writes

    def finish(i0, handle):
        nonlocal last
        displays = _ready(handle)
        times.extend([(time.perf_counter() - last) / len(displays)]
                     * len(displays))
        emit(i0, displays)
        last = time.perf_counter()

    pending = None  # (first index, fetch handle) not yet read back
    i = 0
    while i < n_frames:
        gi = min(g, n_frames - i)
        state, displays = steps(scene, cfg, gi, state, angular_speed,
                                mesh_speed=mesh_speed)
        handle = _fetch(displays)
        if pending is not None:
            finish(*pending)
            pending = None
        if pipelined:
            pending = (i, handle)
        else:
            finish(i, handle)
        i += gi
    if pending is not None:
        finish(*pending)
    if not times:
        return state, {"frames": 0, "mean_ms": 0.0, "fps": 0.0,
                       "p95_ms": 0.0, "first_frame_ms": 0.0}
    mean = float(np.mean(times))
    return state, {"frames": n_frames, "mean_ms": mean * 1e3,
                   "fps": 1.0 / mean,
                   "p95_ms": float(np.percentile(times, 95) * 1e3),
                   "first_frame_ms": float(times[0] * 1e3)}
