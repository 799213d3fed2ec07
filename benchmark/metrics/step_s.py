"""The window's seconds over the fitting steps finished in it."""


def read(run):
    n = len(run.window.latencies)
    return run.window.elapsed / n if n else None
