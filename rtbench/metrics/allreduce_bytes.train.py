"""allreduce_bytes.train: the bytes a call of the trainer's all-reduce
carries from this rank (``mesh.allreduce_bytes`` over
``mesh.allreduce_calls``, part ``train``; one counted step,
rtbench/spans.py)."""
from rtbench import spans


def read(run):
    n = spans.counters(run)
    if n is None:
        return None
    calls = n.get("mesh.allreduce_calls", {}).get("train")
    sent = n.get("mesh.allreduce_bytes", {}).get("train")
    return None if sent is None or not calls else sent / calls
