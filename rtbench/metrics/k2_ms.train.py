"""k2_ms.train: device ms a step of K2, the replay backward."""


def read(run):
    return run.trace.layer_ms("k2")
