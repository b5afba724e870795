"""live_share.render: of the rays K1 launches in phases 1 and later, the
share live at the phase's entry, in percent (``k1.rays_live_in`` over
``k1.rays_launched``; one counted frame, rtbench/spans.py)."""
from rtbench import spans


def read(run):
    n = spans.counters(run)
    if n is None:
        return None
    later = [k for k in n.get("k1.rays_launched", {})
             if k.startswith("phase") and k != "phase0"]
    launched = spans.part_sum(n, "k1.rays_launched", later)
    live = spans.part_sum(n, "k1.rays_live_in", later)
    return None if not launched or live is None else 100.0 * live / launched
