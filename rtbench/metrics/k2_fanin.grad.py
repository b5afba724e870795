"""k2_fanin.grad: the bounces K2 replays an atomic row-add into its slot
table (``k2.bounces`` over ``k2.row_adds``; one counted step,
rtbench/spans.py)."""
from rtbench import spans


def read(run):
    n = spans.counters(run)
    if n is None:
        return None
    bounces = n.get("k2.bounces", {}).get("total")
    adds = n.get("k2.row_adds", {}).get("total")
    return None if bounces is None or not adds else bounces / adds
