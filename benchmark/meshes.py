"""Where a configuration's mesh comes from: one resolver turns the
``scene.mesh`` entry of a configuration into the OBJ file that both the
program and the reference read.

- ``{"obj": "cat", ...}``: the repo's cat, which the program's preset
  loads itself (``Mesh.preset_own``): the program is built as the preset
  builds it, with no ``obj_path``;
- ``{"obj": name, ...}``: the OBJ file ``objs/<name>.obj`` beside this
  module, which the program reads through ``Renderer(obj_path=...)``, as
  ``cli render --obj`` does.

``scale`` and ``offset`` stay in the entry, and both sides apply them:
the program through ``Renderer(obj_scale=, obj_offset=)``, the reference
in ``reference.build_scene``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass

# the committed OBJ files a configuration may name
OBJ_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "objs")
# the keys of a mesh entry: all but material and smooth_normals required
ENTRY_KEYS = ("obj", "scale", "offset", "material", "smooth_normals")
REQUIRED = ("obj", "scale", "offset")


@dataclass(frozen=True)
class Mesh:
    """A configuration's mesh, resolved."""

    path: str            # the OBJ both sides read
    scale: float
    offset: tuple
    preset_own: bool     # the preset's own cat: the program loads it

    def program_args(self) -> dict:
        """The ``Renderer`` keywords that give the program this mesh: none
        for the preset's own cat."""
        if self.preset_own:
            return {}
        return {"obj_path": self.path, "obj_scale": self.scale,
                "obj_offset": self.offset}


def cat_path() -> str:
    """The repo's cat, where the program finds it (``RT_CAT_OBJ`` points
    at another copy)."""
    from raytracinggpu_tpu_torch.scene.obj import CAT_OBJ_PATH

    return CAT_OBJ_PATH


def choices() -> list:
    """The names a mesh entry's ``obj`` may take."""
    files = os.listdir(OBJ_DIR) if os.path.isdir(OBJ_DIR) else []
    return ["cat"] + sorted(f[:-4] for f in files if f.endswith(".obj"))


def resolve(config: dict) -> Mesh | None:
    """The mesh of a configuration (None where its scene has none);
    raises ValueError for an entry that names no known OBJ, or that lacks
    or holds a key the scene does not read."""
    entry = config["scene"].get("mesh")
    if entry is None:
        return None
    extra = set(entry) - set(ENTRY_KEYS)
    missing = set(REQUIRED) - set(entry)
    if extra or missing:
        raise ValueError(f"a mesh entry takes the keys {list(ENTRY_KEYS)}; "
                         f"unknown {sorted(extra)}, missing "
                         f"{sorted(missing)}")
    name = entry["obj"]
    if name not in choices():
        raise ValueError(f"unknown mesh obj {name!r}; choose from "
                         f"{choices()}")
    scale = float(entry["scale"])
    offset = tuple(float(x) for x in entry["offset"])
    if name == "cat":
        return Mesh(cat_path(), scale, offset, preset_own=True)
    return Mesh(os.path.join(OBJ_DIR, f"{name}.obj"), scale, offset,
                preset_own=False)
