"""engine_host_ms.grad: host ms a step covered by the port's
``rt.grad.forward`` and ``rt.grad.backward`` spans, the union of their
intervals across threads (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return (None if s is None
            else s.host_ms(("rt.grad.forward", "rt.grad.backward")))
