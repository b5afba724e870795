"""schedule_ms.render: device ms a frame of every operation that is not
K1: the compaction schedule's boundary sorts, gathers, unpermute and
packing, and their copies and sets."""


def read(run):
    return run.trace.layer_ms(None, exclude=("k1",))
