"""Device time of the mesh-query kernels (``pairs_kernel`` in its
shadow, closest and smooth-closest modes: B2, B1, B3) in the traced
window, by kernel name, over the window's frames, in ms."""
import re

MESH_QUERY = re.compile(r"pairs_kernel<[023]>")


def seconds(run):
    """The mesh-query kernels' device seconds in the window, or None."""
    if not run.ops:
        return None
    s = sum(e - b for n, b, e in run.ops if MESH_QUERY.search(n))
    return s or None


def read(run):
    s = seconds(run)
    if s is None or not run.frames:
        return None
    return s / run.frames * 1e3
