"""rays_host_ms.render: host ms a frame of the port's ``rt.rays`` span: the
params vector built, pinned and copied to the card (rtbench/spans.py)."""
from rtbench import spans


def read(run):
    s = spans.of_run(run)
    return None if s is None else s.host_ms(("rt.rays",))
