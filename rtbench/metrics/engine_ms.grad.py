"""engine_ms.grad: device ms a step of every operation that is neither K1d
nor K2: the engine's cluster build, sorts, scatters, index_add_, the
camera's product and the loss."""


def read(run):
    return run.trace.layer_ms(None, exclude=("k1", "k2"))
