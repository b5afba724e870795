"""submit_ms.grad: host ms from the call of f through the return of
loss.backward() (the harness's span around the calls)."""


def read(run):
    return run.trace.span_ms("submit")
