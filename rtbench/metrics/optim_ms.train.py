"""optim_ms.train: device ms a step under the port's ``rt.optim`` span: the
gradients masked, the optimizer's step and the clamps (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return None if s is None else s.device_ms(("rt.optim",))
