"""The part of the traced steps' time under the autograd engine's backward
ranges, over the steps' time."""

from benchmark import readers


def read(run):
    tr = run.trace
    steps = tr.named("step") if tr is not None else []
    total = sum(s.end - s.start for s in steps) / 1e6
    if total <= 0:
        return None
    return readers.under(tr.backward, steps) / total
