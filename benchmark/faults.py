"""Faults planted in the program's timed path, to show that the check
catches them: each replaces, for the length of a run, a function that the
program looks up by module attribute at each call.  The test of the check
plants them under a whole run on the CPU (``tests/test_bench_faults.py``);
``calibrate.py --fault`` reads them on the card at a cell's own size.

Global faults touch every pixel; mesh faults touch only what the mesh
makes: its shading, its shadows, the light it bounces.  Where a fault
applies is read from a cell's configuration and traffic, never from its
name.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

PKG = "raytracinggpu_tpu_torch"
INF = 1e9 + 9


def half_the_samples(fn):
    """Half of the batch left out, the mean taken over the rest."""
    def call(scene, cfg, cam, key, rows, sample_ids):
        ids = list(sample_ids)
        acc, stats = fn(scene, cfg, cam, key, rows, ids[:len(ids) // 2])
        return acc * (len(ids) / (len(ids) // 2)), stats
    return call


def altered_paths(fn):
    """Every path's radiance altered where it is produced."""
    return lambda *a, **k: fn(*a, **k) * 1.05


def state_unchanged(fn):
    """A step that returns its state unchanged."""
    def call(scene, cfg, state, *a, **k):
        _, display = fn(scene, cfg, state, *a, **k)
        return state, display
    return call


def display_altered(fn):
    """The display altered where it is produced: every byte's lowest bit
    flipped (the scene saturates most of a small frame at 255, so a change
    of gamma alone would leave it as it was)."""
    return lambda img: fn(img) ^ 1


def shadow_ignores_mesh(fn):
    """The mesh's shadow cast (B2) runs, and its answer is dropped: no
    shadow ray is blocked by the cat."""
    def call(*a, **k):
        t = fn(*a, **k)
        return torch.full_like(t, INF)
    return call


def flat_normals(fn):
    """The smooth closest cast (B3) replaced by the flat one (B1): the
    cat's Phong normals lost."""
    def call(*a, **k):
        if k.get("payload") == "smooth":
            k = dict(k, payload="geom")
        return fn(*a, **k)
    return call


def tenth_dropped(fn):
    """Every tenth triangle of the OBJ left out of the program's mesh,
    the preset's cat or a custom mesh."""
    def call(*a, **k):
        obj = fn(*a, **k)
        keep = np.arange(obj.vtx.shape[0]) % 10 != 0
        for f in ("vtx", "nrm", "uv"):
            setattr(obj, f, getattr(obj, f)[keep])
        if obj.group.shape[0] == keep.shape[0]:
            obj.group = obj.group[keep]
        return obj
    return call


def everywhere(cell) -> bool:
    return True


def has_mesh(cell) -> bool:
    return cell.config["scene"].get("mesh") is not None


def smooth_mesh(cell) -> bool:
    return bool(has_mesh(cell)
                and cell.config["scene"]["mesh"].get("smooth_normals"))


def loop(cell) -> bool:
    return cell.traffic["driver"] == "realtime"


# fault -> (the (module, attribute) pairs it replaces, its wrapper, whether
# a cell can have it, read from the cell's configuration and traffic); the
# realtime module holds its own binding of render_rows, and the preset's
# cat (scene.mesh.load_cat_mesh) and a custom mesh (api._custom_mesh) each
# read their OBJ through their module's own binding of read_obj
FAULTS = {
    "half_the_samples": ((("render.pipeline", "render_rows"),
                          ("render.realtime", "render_rows")),
                         half_the_samples, everywhere),
    "altered_paths": ((("integrator.wavefront", "composite"),),
                      altered_paths, everywhere),
    "state_unchanged": ((("render.realtime", "step"),), state_unchanged,
                        loop),
    "display_altered": ((("render.realtime", "tonemap_device"),),
                        display_altered, loop),
    "shadow_ignores_mesh": ((("integrator.wavefront",
                              "intersect_tris_pairs_shadow"),),
                            shadow_ignores_mesh, has_mesh),
    "flat_normals": ((("integrator.wavefront", "intersect_tris_pairs"),),
                     flat_normals, smooth_mesh),
    "tenth_dropped": ((("scene.mesh", "read_obj"), ("api", "read_obj")),
                      tenth_dropped, has_mesh),
}
MESH_FAULTS = ("shadow_ignores_mesh", "flat_normals", "tenth_dropped")


def applies(fault: str, cell) -> bool:
    """Whether ``cell`` (a ``spec.Cell``) can have ``fault``."""
    return FAULTS[fault][2](cell)


def plant(fault: str) -> list:
    """Plant ``fault`` in the program; returns the callables that undo it."""
    where, wrap, _ = FAULTS[fault]
    undo = []
    for mod, attr in where:
        m = importlib.import_module(f"{PKG}.{mod}")
        fn = getattr(m, attr)
        setattr(m, attr, wrap(fn))
        undo.append(lambda m=m, attr=attr, fn=fn: setattr(m, attr, fn))
    return undo
