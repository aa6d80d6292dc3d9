"""Rays a second over the window: every frame the window completed times
the frame's ray count (the reference's formula, fixed by the
configuration and the traffic), over the window's wall time, in Mray/s."""


def read(run):
    if not run.frames or run.window_s <= 0:
        return None
    return run.frames * run.rays_per_frame / run.window_s / 1e6
