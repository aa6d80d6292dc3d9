"""Render-state checkpoint and resume (port of
``raytracinggpu_tpu/utils/checkpoint.py``).

The file is the JAX package's npz layout: the state's leaves in order as
``arr_0`` ... ``arr_10`` (accum, frames, rng_frame, light_angle,
mesh_angle, cam_c x/y/z, yaw, pitch, and the threefry key as a (2,)
uint32 array), plus ``treedef`` and ``n_leaves``.  A checkpoint written by
either package resumes in the other, and a resumed loop continues with the
same frames bit for bit.  The older 10-leaf layout (without mesh_angle)
loads with mesh_angle 0.
"""
from __future__ import annotations

import numpy as np

from raytracinggpu_tpu_torch.convert import render_state_from_numpy
from raytracinggpu_tpu_torch.core.vec import Vec3
from raytracinggpu_tpu_torch.render.realtime import RenderState


def save_state(path: str, state: RenderState) -> None:
    leaves = [state.accum, state.frames, state.rng_frame, state.light_angle,
              state.mesh_angle, *state.cam_c, state.yaw, state.pitch]
    key = np.array([int(k) for k in state.key], np.uint32)
    np.savez(path, *[t.cpu().numpy() for t in leaves], key,
             treedef="RenderState", n_leaves=len(leaves) + 1)


def load_state(path: str, device) -> RenderState:
    with np.load(path, allow_pickle=False) as data:
        n = int(data["n_leaves"])
        leaves = [data[f"arr_{i}"] for i in range(n)]
    if n == 10:
        # saved before the state had mesh_angle: the default pose
        leaves.insert(4, np.float32(0.0))
    elif n != 11:
        raise ValueError(f"unrecognized checkpoint layout: {n} leaves "
                         "(supported: 10 [without mesh_angle] or 11)")
    return render_state_from_numpy(
        RenderState(*leaves[:5], Vec3(*leaves[5:8]), *leaves[8:]), device)
