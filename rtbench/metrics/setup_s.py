"""setup_s: from the start of the process to the start of the window: torch
and the CUDA context, the kernels built or loaded, the inputs drawn, the
scene prepared and the warm-up (host clock)."""


def read(run):
    return run.window.setup_s
