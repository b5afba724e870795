"""step_ms: the window's time over the steps completed in it (host clock)."""


def read(run):
    return run.window.mean_ms()
