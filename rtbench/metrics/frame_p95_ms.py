"""frame_p95_ms: the 95th percentile of every frame's latency in the
window, from its submission to its synchronised completion (host clock)."""


def read(run):
    return run.window.p95_ms()
