"""trainer_host_ms.train: the trainer's own host ms a step: the host time
under the port's ``rt.train`` span less that under the engine's
``rt.grad.forward`` and ``rt.grad.backward``, which lie inside it (the
backward on autograd's thread while the step waits for it; each the union
of its intervals, rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    if s is None:
        return None
    step = s.host_ms(("rt.train",))
    engine = s.host_ms(("rt.grad.forward", "rt.grad.backward"))
    return None if step is None or engine is None else step - engine
