"""layout_ms.train: device ms a step under the port's ``rt.layout`` span: the
scene's cluster layout, built every step (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return None if s is None else s.device_ms(("rt.layout",))
