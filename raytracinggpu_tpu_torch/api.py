"""High-level API facade (port of ``raytracinggpu_tpu/api.py``).

One object wraps the preset, scene and pipeline plumbing:

    from raytracinggpu_tpu_torch import Renderer

    r = Renderer("array_bvh", spp=32, max_depth=5)    # on the CUDA device
    image = r.render()                       # (H, W, 3) uint8
    hdr, stats = r.render_hdr(seed=1)        # radiance + TraceStats
    for frame in r.animate(60):              # circulating-light frames
        ...
    big = Renderer("array_bvh", obj_path="mesh.obj", bvh_builder="lbvh")
    walk = Renderer("array_bvh", traversal="bvh")   # the flat-BVH walk
    paved = Renderer("array_bvh", pairs_cluster="sah", pairs_pack="pave",
                     pairs_cut=32)                 # the same frames
    spin = Renderer("realtime", animate_mesh=True)  # animate() spins the cat
    hdr, stats = r.render_sharded()      # in each rank of a world

The renderer runs on ``device``, the CUDA device unless the caller asks
for another (``device="cpu"`` runs every kernel's plain PyTorch version);
without a CUDA device the default raises.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from raytracinggpu_tpu_torch.core.device import render_device
from raytracinggpu_tpu_torch.core.rng import PRNGKey
from raytracinggpu_tpu_torch.integrator.wavefront import TraceStats
from raytracinggpu_tpu_torch.parallel.sharding import (
    make_mesh,
    render_frame_sharded,
)
from raytracinggpu_tpu_torch.render.image_io import tonemap, write_png
from raytracinggpu_tpu_torch.render.pipeline import (
    Camera,
    render_preset_frame,
)
from raytracinggpu_tpu_torch.render.realtime import (
    init_state,
    reset_accumulation,
    step,
    steps,
)
from raytracinggpu_tpu_torch.scene.mesh import (
    build_mesh,
    load_cat_mesh,
    rescale,
)
from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH, read_obj
from raytracinggpu_tpu_torch.scene.presets import (
    _MESH_TRANSFORM,
    PRESET_NAMES,
    build_preset,
)
from raytracinggpu_tpu_torch.utils.profiling import build_span


def _custom_mesh(preset, obj_path, obj_scale, obj_offset, bvh_builder):
    """The mesh a Renderer puts in the preset's cat's place (the span
    ``build.mesh``, the parse and the placement ``build.obj`` in it): the
    OBJ at ``obj_path``, or the preset's cat built with another BVH
    builder; None for the preset's own cat, which ``build_preset``
    loads."""
    if obj_path is None and (bvh_builder == "reference"
                             or preset not in _MESH_TRANSFORM):
        return None
    with build_span("build.mesh"):
        if obj_path is None:
            # the preset's cat with the requested BVH builder
            return load_cat_mesh(CAT_OBJ_PATH, *_MESH_TRANSFORM[preset],
                                 builder=bvh_builder)
        with build_span("build.obj"):
            obj = read_obj(obj_path)
            if obj_scale is not None or \
                    tuple(obj_offset) != (0.0, 0.0, 0.0):
                # v -> v*scale + offset; an offset alone keeps scale 1
                obj.vertices = rescale(obj.vertices,
                                       1.0 if obj_scale is None
                                       else obj_scale, obj_offset)
        return build_mesh(obj, builder=bvh_builder)


class Renderer:
    """A configured scene + render pipeline.

    Args mirror RenderConfig / the CLI: preset name, resolution, spp,
    max_depth, traversal mode (``pairs``, ``pallas``, ``dense``, ``bvh``),
    the clustering knobs and ``animate_mesh``, plus
    ``obj_path``/``obj_scale``/``obj_offset``
    for custom meshes, ``bvh_builder`` ("reference" | "lbvh") and
    ``device`` (default: the CUDA device).
    """

    def __init__(self, preset: str = "array_bvh", obj_path: str | None = None,
                 obj_scale: float | None = None, obj_offset=(0.0, 0.0, 0.0),
                 bvh_builder: str = "reference", device=None,
                 **config_overrides):
        if preset not in PRESET_NAMES:
            raise ValueError(
                f"unknown preset {preset!r}; choose from {PRESET_NAMES}")
        if obj_path is not None and preset == "showcase":
            raise ValueError(
                "the 'showcase' preset has no mesh slot; use a mesh preset "
                "(e.g. 'array_bvh') with obj_path")
        self.device = render_device(device)
        with build_span("build"):
            mesh = _custom_mesh(preset, obj_path, obj_scale, obj_offset,
                                bvh_builder)
            self.cfg, self.scene = build_preset(preset, self.device,
                                                mesh=mesh, **config_overrides)
        self._mesh = None  # render_sharded's default mesh

    # -- single frames ---------------------------------------------------
    def render_hdr(self, seed: int = 0, camera=None):
        """Full-precision radiance (H, W, 3) float32 numpy image and the
        TraceStats (numpy arrays)."""
        return render_preset_frame(self.scene, self.cfg, seed=seed, cam=camera)

    def render(self, seed: int = 0, camera=None) -> np.ndarray:
        """Tonemapped uint8 frame (the reference's gamma-2.2 clamp)."""
        img, _ = self.render_hdr(seed=seed, camera=camera)
        return tonemap(img)

    def save(self, path: str, seed: int = 0, camera=None) -> None:
        write_png(path, self.render(seed=seed, camera=camera))

    # -- progressive / animated ------------------------------------------
    def animate(self, n_frames: int, seed: int = 0, light_speed: float = 1.0,
                batch: int = 1, reset_each: bool = True
                ) -> Iterator[np.ndarray]:
        """Yield uint8 frames of the circulating-light loop.  batch > 1
        enqueues that many frames before reading any back
        (``render.realtime.steps``), bitwise the frames of batch 1;
        reset_each clears the progressive accumulator every frame (a crisp
        animation) instead of accumulating (a converging still)."""
        state = init_state(self.cfg, self.scene, seed)
        speed = np.float32(light_speed)
        done = 0
        while done < n_frames:
            if batch > 1 and n_frames - done >= batch:
                state, frames = steps(self.scene, self.cfg, batch, state,
                                      speed, reset_each=reset_each)
                yield from frames.cpu().numpy()
                done += batch
            else:
                state, frame = step(self.scene, self.cfg, state, speed)
                yield frame.cpu().numpy()
                if reset_each:
                    state = reset_accumulation(state)
                done += 1

    # -- multi-device -----------------------------------------------------
    def render_sharded(self, seed: int = 0, mesh=None):
        """Render across a mesh of ranks (``parallel/sharding.py``): every
        rank of the initialised ``torch.distributed`` world calls it, each
        with its Renderer on its own device.  ``mesh`` defaults to every
        rank on the pixel axis; with no group the world is this process
        alone, and the frame is ``render_hdr``'s.  Returns (radiance (H, W,
        3) float32 numpy image, TraceStats of numpy arrays summed over the
        world), the frame bitwise ``render_hdr``'s on any mesh."""
        if mesh is None:
            if self._mesh is None:  # dist.new_group is collective: once
                self._mesh = make_mesh(device=self.device)
            mesh = self._mesh
        cam = Camera.default(self.cfg, self.device)
        img, stats = render_frame_sharded(self.scene, self.cfg, cam,
                                          PRNGKey(seed, self.device), mesh)
        return img.cpu().numpy(), TraceStats(*(s.cpu().numpy()
                                               for s in stats))
