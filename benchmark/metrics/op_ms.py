"""op_ms: the window's length over the operations it completed, in ms (one
caller waits for each, so this is 1 / throughput)."""


def read(run):
    w = run.window
    return w.seconds * 1e3 / len(w.done) if w.done else None
