"""The mesh casts at depth 1 or deeper that took a tier of the
compaction ladder (a compacted cast), over all mesh casts at those
depths in the traced window, in %."""


def read(run):
    if run.spans is None:
        return None
    casts = sum(n for d, n in run.spans.casts.items() if d >= 1)
    if not casts:
        return None
    tiered = sum(1 for d, c, _ in run.spans.tiers.log if d >= 1 and c > 0)
    return tiered / casts * 100.0
