"""k1_ms.render: device ms a frame of the K1 (megakernel) launches."""


def read(run):
    return run.trace.layer_ms("k1")
