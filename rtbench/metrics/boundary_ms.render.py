"""boundary_ms.render: device ms a frame under the port's ``rt.boundary<k>``
and ``rt.unpermute`` spans: the compaction schedule's packing, keys, sorts,
gathers and concatenations, and the final merge and unpermute sort
(rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return (None if s is None
            else s.device_ms(("rt.boundary*", "rt.unpermute")))
