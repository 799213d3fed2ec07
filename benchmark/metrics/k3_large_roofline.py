"""K3's large instance's share of its bound, in %: the least time the
H100 SXM could take for the table rows, chunk bounds and planes that the
traced launches' lanes need (``yardstick.counts.render_counts`` over the
work of the reference's walk: its live nodes and the sphere chunks they
enter), over the tree kernel's device time.  A launch's lanes are the
``lanes`` that its wrapper's span counted; where the program's spans
carry no such count (a program older than the count), the traced lanes
shared evenly among the launches."""

from benchmark import program_spans, readers
from benchmark.yardstick import counts

KERNEL = "megakernel_tree"


def _launch_lanes(run, n: int) -> list:
    """The lanes of each of the ``n`` traced launches."""
    prog = program_spans.traced(run)
    spans = [] if prog is None else prog.named(KERNEL)
    lanes = [r.counts["lanes"] for r in spans if "lanes" in r.counts]
    return lanes if len(lanes) == n else [run.traced_lanes() / n] * n


def read(run):
    ops = readers.kernel_ops(run, KERNEL)
    if not ops or not run.large:
        return None
    work = run.work()
    ms = sum(counts.bound(*counts.render_counts(run.spec, lanes, work,
                                                large=True))[0]
             for lanes in _launch_lanes(run, len(ops)))
    return 100.0 * ms / (sum(o.seconds for o in ops) * 1e3)
