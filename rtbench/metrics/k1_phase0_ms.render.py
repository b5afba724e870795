"""k1_phase0_ms.render: device ms a frame under the port's ``rt.phase0``
span: the first phase's depth cap and its K1 launch (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return None if s is None else s.device_ms(("rt.phase0",))
