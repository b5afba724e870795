"""k2_roofline.grad: K2's share of its roofline, in percent: the least
time of the backward of a step's segments as the reference counts them
(rtbench/roofline.py) over K2's device time a step."""
from rtbench import roofline


def read(run):
    ms = run.trace.layer_ms("k2")
    if not ms or run.trace.work is None:
        return None
    return 100.0 * roofline.k2_bound_s(run.trace.work) * 1e3 / ms
