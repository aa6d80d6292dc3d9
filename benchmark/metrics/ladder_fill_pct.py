"""The share of a compacted mesh cast's lanes that carry a live ray: the
active counts over the tiers taken (the capacity C of the B1/B2/B3
launch), summed over the casts that took a tier of the compaction
ladder, from the program's counters ``ladder.active`` and
``ladder.capacity`` (``ops/pairs_trace._tier``) in the traced run, in
%."""
from benchmark import program


def read(run):
    trace = program.of(run)
    if trace is None or not trace.counters.get("ladder.capacity"):
        return None
    c = trace.counters
    return c["ladder.active"] / c["ladder.capacity"] * 100.0
