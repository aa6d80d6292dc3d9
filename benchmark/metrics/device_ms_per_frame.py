"""The union of the device operations' intervals in the traced window,
over the frames the window completed, in ms."""


def read(run):
    if not run.ops or not run.frames:
        return None
    return run.busy_s / run.frames * 1e3
