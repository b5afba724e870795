"""device_idle.train: the share of the traced window, in percent, in
which no device operation ran (the union of their intervals)."""


def read(run):
    idle = run.trace.idle_share()
    return None if idle is None else 100.0 * idle
