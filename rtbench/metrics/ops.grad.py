"""ops.grad: device operations a step under any of the port's ``rt.`` spans
(rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return None if s is None else s.device_ops(("rt.*",))
