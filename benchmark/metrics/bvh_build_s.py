"""Seconds of the host build's BVH: the program's ``build.bvh`` span (the
builder's work in ``scene/mesh.build_mesh``: ``accel/lbvh.py`` or
``accel/bvh.py``) of the run's own build, the last that ended before the
window.  The program keeps its build's spans in a build record whether
or not a profiler session records (``collect().build``); a program
without that record gives None."""


def read(run):
    try:
        from raytracinggpu_tpu_torch.utils import profiling
    except ImportError:
        return None
    collect = getattr(profiling, "collect", None)
    build = getattr(collect() if collect else None, "build", None)
    if build is None:
        return None
    t0_ns = run.t0 * 1e9
    ns = [s.end_ns - s.start_ns for s in build.spans
          if s.name == "build.bvh" and s.end_ns is not None
          and s.end_ns <= t0_ns]
    return ns[-1] * 1e-9 if ns else None
