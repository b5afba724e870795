"""k1_roofline.render: K1's share of its roofline, in percent: the least
time of a frame's work as the reference counts it (rtbench/roofline.py)
over K1's device time a frame."""
from rtbench import roofline


def read(run):
    ms = run.trace.layer_ms("k1")
    if not ms or run.trace.work is None:
        return None
    return 100.0 * roofline.k1_bound_s(run.trace.work) * 1e3 / ms
