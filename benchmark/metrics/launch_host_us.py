"""Host microseconds inside the program's kernel launch wrappers
(``ops/_kernels.py``: the checks, the output allocations and the ctypes
call, from entering a wrapper to its return) over the calls they made:
the sums of the counters ``launch.<wrapper>.ns`` and
``launch.<wrapper>.calls`` of the program's tracer in the traced run (the
window and the warm-up frame before it, ``program.py``)."""
from benchmark import program


def read(run):
    trace = program.of(run)
    if trace is None:
        return None
    ns = calls = 0
    for k, v in trace.counters.items():
        if k.startswith("launch.") and k.endswith(".ns"):
            ns += v
        elif k.startswith("launch.") and k.endswith(".calls"):
            calls += v
    return ns / calls / 1e3 if calls else None
