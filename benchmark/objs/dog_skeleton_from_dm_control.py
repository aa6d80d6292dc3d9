"""Write ``dog_skeleton.obj`` from the dog model of DeepMind's dm_control:

    python3 benchmark/objs/dog_skeleton_from_dm_control.py [--out PATH]

Source: dm_control (https://github.com/google-deepmind/dm_control),
licence Apache-2.0, its suite's dog (``dm_control/suite/dog.xml``, the
meshes ``dm_control/suite/dog_assets/BONE*.stl``), described in
Tunyasuvunakool et al., "dm_control: Software and Tasks for Continuous
Control", arXiv:2006.12983.  The script reads the installed package and
fetches nothing; where ``dm_control`` cannot be found it says so and
exits 1.

``dog.xml`` names 162 bone meshes (``<mesh file="BONE...">``).  Their
binary STL files share one frame, the skeleton in its rest pose (each
bone's geom sits at minus its body's offset), so concatenated in the
file order of ``dog.xml`` they are the assembled skeleton: 308,472
triangles.  Vertices equal in float32 are merged, in the order they are
first seen (152,930).  The model is z-up; the OBJ is y-up, by (x, y, z)
-> (x, z, -y), a swap and a negation, so nothing is rounded before the
text.  Written are ``v`` lines (``%.6g``) and 1-based ``f`` lines only:
no normals, texture coordinates or comments.  The same installed files
give the same bytes.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import xml.etree.ElementTree as ET

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "dog_skeleton.obj")
# a binary STL triangle: normal, three corners (f32 each), attribute
STL_TRI = np.dtype([("n", "<f4", 3), ("v", "<f4", (3, 3)), ("a", "<u2")])


def suite_dir() -> str | None:
    """The installed ``dm_control/suite`` directory, or None."""
    try:
        spec = importlib.util.find_spec("dm_control")
    except (ImportError, ValueError):
        return None
    if spec is None or not spec.submodule_search_locations:
        return None
    return os.path.join(list(spec.submodule_search_locations)[0], "suite")


def bone_files(suite: str) -> list:
    """The STL paths of ``dog.xml``'s ``BONE`` meshes, in file order."""
    root = ET.parse(os.path.join(suite, "dog.xml")).getroot()
    meshdir = root.find("compiler").get("meshdir", "")
    return [os.path.join(suite, meshdir, m.get("file"))
            for m in root.iter("mesh")
            if m.get("file", "").startswith("BONE")]


def read_stl(path: str) -> np.ndarray:
    """(T, 3, 3) float32 corners of a binary STL file."""
    with open(path, "rb") as f:
        data = f.read()
    n = int(np.frombuffer(data, "<u4", 1, 80)[0])
    if len(data) != 84 + n * STL_TRI.itemsize:
        raise ValueError(f"{path}: not a binary STL of {n} triangles")
    return np.frombuffer(data, STL_TRI, n, 84)["v"]


def skeleton(suite: str) -> tuple:
    """(vertices (V, 3) f32 y-up, faces (T, 3) int64 0-based)."""
    corners = np.concatenate([read_stl(p) for p in bone_files(suite)])
    pts = corners.reshape(-1, 3)
    # equal in f32 (0.0 and -0.0 alike): compare values, not bytes
    pts = pts + np.float32(0.0)
    _, first, inverse = np.unique(pts, axis=0, return_index=True,
                                  return_inverse=True)
    order = np.argsort(first, kind="stable")  # first-seen order
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    verts = pts[first[order]]
    faces = rank[inverse.reshape(-1)].reshape(-1, 3)
    yup = np.stack([verts[:, 0], verts[:, 2], -verts[:, 1]], axis=1)
    return yup.astype(np.float32), faces


def obj_text(verts: np.ndarray, faces: np.ndarray) -> str:
    v = "".join("v %.6g %.6g %.6g\n" % tuple(p) for p in verts.tolist())
    f = "".join("f %d %d %d\n" % tuple(t) for t in (faces + 1).tolist())
    return v + f


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT, help=f"default: {OUT}")
    a = p.parse_args(argv)
    suite = suite_dir()
    if suite is None or not os.path.isfile(os.path.join(suite, "dog.xml")):
        print("dog_skeleton: dm_control is not installed (its suite's "
              "dog.xml is the source); nothing written", file=sys.stderr)
        return 1
    verts, faces = skeleton(suite)
    with open(a.out, "w", newline="\n") as f:
        f.write(obj_text(verts, faces))
    print(f"{a.out}: {len(verts)} vertices, {len(faces)} triangles")
    return 0


if __name__ == "__main__":
    sys.exit(main())
