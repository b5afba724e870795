"""k1_ms.train: device ms a step of K1d, the megakernel's record mode."""


def read(run):
    return run.trace.layer_ms("k1")
