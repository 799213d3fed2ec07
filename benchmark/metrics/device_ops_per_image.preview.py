"""Device kernels and copies per traced preview image."""


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or not run.window.traced:
        return None
    return len(tr.ops) / run.window.traced
