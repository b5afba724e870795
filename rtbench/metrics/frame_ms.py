"""frame_ms: the window's time over the frames completed in it (host clock)."""


def read(run):
    return run.window.mean_ms()
