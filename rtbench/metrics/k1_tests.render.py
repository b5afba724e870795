"""k1_tests.render: K1's sphere rows tested a bounce, over every phase
(``k1.slot_tests`` over ``k1.ray_bounces``; one counted frame,
rtbench/spans.py)."""
from rtbench import spans


def read(run):
    n = spans.counters(run)
    if n is None:
        return None
    tests = n.get("k1.slot_tests", {}).get("total")
    bounces = n.get("k1.ray_bounces", {}).get("total")
    return None if tests is None or not bounces else tests / bounces
