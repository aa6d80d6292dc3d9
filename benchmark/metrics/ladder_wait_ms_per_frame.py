"""The host's wait inside the ladder's ``_tier`` (the read of a cast's
active count), summed over the traced window, over its frames, in ms."""


def read(run):
    if run.spans is None or not run.spans.tiers.log or not run.frames:
        return None
    return sum(w for _, _, w in run.spans.tiers.log) / run.frames * 1e3
