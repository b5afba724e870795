"""allreduce_ms.train: device ms a step of the trainer's all-reduce: the
operations under the port's ``rt.allreduce`` span (the flatten and the
split), and NCCL's own kernels, which the profiler ties to the collective's
host operation and so to no span (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    under = None if s is None else s.device_ms(("rt.allreduce",))
    if under is None:
        return None
    nccl = sum(us for name, us, sp in s.ops
               if sp is None and "nccl" in name.lower())
    return under + nccl / 1e3 / s.units
