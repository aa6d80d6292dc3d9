"""The 95th percentile, over every frame of the window, of the time
between one frame's arrival on the host and the next (the first from the
window's start), in ms.  A traced run reads it from its untraced window
(``source`` host_clock), since the trace slows the host.  The loop is paced by the host's launches, whose
speed drifts by a tenth from run to run on the shared machine, so this
tail is a per-layer reading beside ``mrays_per_s`` and carries no bound."""
import numpy as np


def read(run):
    if not run.frames:
        return None
    return float(np.percentile(run.intervals, 95)) * 1e3
