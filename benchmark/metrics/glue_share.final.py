"""Device time in kernels other than the port's hand-written ones (the
sampler's and the wrapper's glue), over all device time."""

from benchmark import readers


def read(run):
    tr = run.trace
    if tr is None or not tr.ops:
        return None
    names = readers.handwritten_kernels()
    glue = sum(o.seconds for o in tr.ops
               if o.is_kernel and not readers.is_handwritten(o.name, names))
    return glue / sum(o.seconds for o in tr.ops)
