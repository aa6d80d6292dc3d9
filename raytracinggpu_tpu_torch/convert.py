"""Carry the JAX package's host tables and config across to the port.

``scene_tables_from_numpy`` takes the JAX ``SceneTables`` with every leaf
converted to numpy (``jax.tree.map(np.asarray, tables)``) and returns the
port's ``SceneTables`` on ``device``, so both packages compute on
identical tables.  ``render_config_from_dict`` does the same for a
``dataclasses.asdict`` of the JAX ``RenderConfig``, and
``render_state_from_numpy`` for the realtime loop's ``RenderState``.  All
read fields by name and import neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytracinggpu_tpu_torch.core.rng import Key
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.ops.pairs_trace import PairsMeshTables
from raytracinggpu_tpu_torch.ops.sphere import SphereTable
from raytracinggpu_tpu_torch.render.realtime import RenderState
from raytracinggpu_tpu_torch.scene.scene import (
    Materials,
    RenderConfig,
    SceneTables,
)


# The JAX RenderConfig's mode fields and the one value of each the port
# renders.
_PORTED_MODES = {"traversal": "pairs", "animate_mesh": False}


def _t(a, device):
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def scene_tables_from_numpy(tables_np, device) -> SceneTables:
    """The JAX package's SceneTables (numpy leaves) -> the port's."""
    s, m, p = tables_np.spheres, tables_np.materials, tables_np.pairs_mesh
    t = lambda a: _t(a, device)
    pairs = None
    if p is not None:
        pairs = PairsMeshTables(*(t(getattr(p, f))
                                  for f in PairsMeshTables._fields))
    return SceneTables(
        spheres=SphereTable(t(s.cx), t(s.cy), t(s.cz), t(s.radius)),
        materials=Materials(
            albedo=Vec3(t(m.albedo.x), t(m.albedo.y), t(m.albedo.z)),
            mirror=t(m.mirror), in_ri=t(m.in_ri), out_ri=t(m.out_ri)),
        pairs_mesh=pairs,
        L=Vec3(t(tables_np.L.x), t(tables_np.L.y), t(tables_np.L.z)),
        intensity=t(tables_np.intensity),
    )


def render_config_from_dict(d: dict) -> RenderConfig:
    """The port's RenderConfig from the fields of ``d`` it has; the JAX
    package's other fields (its TPU tuning knobs) are dropped.  Raises
    NotImplementedError for a mode the port does not render: a traversal
    other than ``pairs``, or the animated mesh."""
    unported = {k: d[k] for k, ok in _PORTED_MODES.items()
                if k in d and d[k] != ok}
    if unported:
        raise NotImplementedError(f"not ported yet: {unported}")
    names = {f.name for f in dataclasses.fields(RenderConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "camera_c" in kw:
        kw["camera_c"] = tuple(kw["camera_c"])
    return RenderConfig(**kw)


def render_state_from_numpy(state_np, device) -> RenderState:
    """The JAX package's realtime RenderState (numpy leaves: ``cam_c`` with
    x/y/z, ``key`` the (2,) uint32 threefry key) -> the port's, on
    ``device``."""
    t = lambda a: _t(a, device)
    key = np.asarray(state_np.key, np.uint32)
    return RenderState(
        accum=t(state_np.accum), frames=t(state_np.frames),
        rng_frame=t(state_np.rng_frame), light_angle=t(state_np.light_angle),
        mesh_angle=t(state_np.mesh_angle),
        cam_c=Vec3(t(state_np.cam_c.x), t(state_np.cam_c.y),
                   t(state_np.cam_c.z)),
        yaw=t(state_np.yaw), pitch=t(state_np.pitch),
        key=Key(*(torch.tensor(int(k), dtype=torch.int64, device=device)
                  for k in key)),
    )
