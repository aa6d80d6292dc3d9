"""The share of the traced window in which no operation ran on the card:
1 - the union of the device operations' intervals over the window's wall
time, both from the same window, in %."""


def read(run):
    if not run.ops or run.window_s <= 0:
        return None
    return (1.0 - run.busy_s / run.window_s) * 100.0
