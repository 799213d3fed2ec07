"""K1's share of its bound, in %: the least time the H100 SXM could take
for what the traced launches' lanes need (``yardstick.counts.k1_bound``
over the work of the reference's paths), over K1's device time."""

from benchmark import readers
from benchmark.yardstick import counts


def read(run):
    ops = readers.kernel_ops(run, "megakernel_linear")
    if not ops or run.large:
        return None
    n = len(ops)
    ms = n * counts.k1_bound(run.spec, run.traced_lanes() / n, run.work())[0]
    return 100.0 * ms / (sum(o.seconds for o in ops) * 1e3)
