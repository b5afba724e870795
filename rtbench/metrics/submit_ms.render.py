"""submit_ms.render: host ms from the call of render() to its return, the
frame's enqueue (the harness's span around the call)."""


def read(run):
    return run.trace.span_ms("submit")
