"""Device operations (kernels, copies, fills) in the traced window over
the frames the window completed."""


def read(run):
    if not run.ops or not run.frames:
        return None
    return len(run.ops) / run.frames
