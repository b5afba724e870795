"""bwd_glue_ms.grad: device ms a step under the port's ``rt.reorder``,
``rt.carry<k>``, ``rt.scatter`` and ``rt.camera`` spans: the backward's work
around K2 (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return (None if s is None else s.device_ms(
        ("rt.reorder", "rt.carry*", "rt.scatter", "rt.camera")))
