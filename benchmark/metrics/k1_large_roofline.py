"""K1's large instance's share of its bound, in %: the least time the
H100 SXM could take for the table rows, chunk bounds and planes that the
traced launches' lanes need (``yardstick.counts.render_counts``, the
chunks from the reference's paths), over the kernel's device time."""

from benchmark import readers
from benchmark.yardstick import counts


def read(run):
    ops = readers.kernel_ops(run, "megakernel_linear")
    if not ops or not run.large:
        return None
    n = len(ops)
    flops, nbytes = counts.render_counts(run.spec, run.traced_lanes() / n,
                                         run.work(), large=True)
    ms = n * counts.bound(flops, nbytes)[0]
    return 100.0 * ms / (sum(o.seconds for o in ops) * 1e3)
