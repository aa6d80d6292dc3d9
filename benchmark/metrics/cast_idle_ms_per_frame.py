"""The device's idle time inside the program's mesh casts: the gaps of
the union of the traced window's device operations that lie inside the
program's ``cast.closest`` and ``cast.shadow`` spans (their children
included), summed as intersected time, over the frames the window
completed, in ms."""
from benchmark import program


def read(run):
    trace = program.of(run)
    if trace is None or not run.ops or not run.frames:
        return None
    casts = program.spans_in(trace, run.t0, run.t_end, program.CASTS)
    if not casts:
        return None
    return program.idle_inside(run, casts) / run.frames * 1e3
