"""Seconds of the host clock around the renderer's construction: the
preset's OBJ parse, BVH, pairs and tiled tables, and their upload."""


def read(run):
    return run.host_build_s
