"""The least time of the mesh work the casts' inputs need, over the
mesh-query kernels' device time, in %.  The work is counted at ray
granularity on one frame after the window (``trace.MeshWork``): for each
ray of each pairs cast, the triangles of every finest (member) box of the
frame's tables that the ray enters over the interval it is given, each a
Moller-Trumbore test of 39 f32 operations at the H100's 67 TFLOP/s.  A
kernel that prunes by distance could test fewer triangles than this count,
and the share would then pass 100%."""
import re

from benchmark import frozen

MESH_QUERY = re.compile(r"pairs_kernel<[023]>")


def read(run):
    if not run.ops or not run.frames or not run.mesh_tests_per_frame:
        return None
    s = sum(e - b for n, b, e in run.ops if MESH_QUERY.search(n))
    if not s:
        return None
    least = (run.mesh_tests_per_frame * frozen.FLOP_PER_MT_TEST
             / frozen.PEAK_F32_FLOPS)
    return least / (s / run.frames) * 100.0
