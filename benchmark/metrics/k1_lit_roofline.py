"""K1's lit instance's share of its bound, in %: the least time the H100
SXM could take for every operation of the traced launches' lanes and
their shadow rays' tests (``yardstick.k1_lit.k1_lit_bound`` over the work
of the lit reference's walk), over the linear kernel's device time.  None
on a large scene, or on a scene without lights, which take other
instances of K1 (``k1_large_roofline``, ``k1_roofline``).

A launch's lanes are the ``lanes`` that its wrapper's span counted;
where no span counts them, the traced lanes, each with its lens samples,
shared evenly among the launches.  Where a span names the instance
(``large``, ``lights``, ``lens``), it has to be the one the scene takes,
else the reader returns None."""

from benchmark import program_spans, readers
from benchmark.yardstick import k1_lit

KERNEL = "megakernel_linear"


def _launch_lanes(run, n: int) -> list | None:
    """The lanes of each of the ``n`` traced launches, or None where a
    launch's span names another instance."""
    spec = run.spec
    want = {"large": 0, "lights": spec.n_lights, "lens": spec.cam_samples}
    prog = program_spans.traced(run)
    spans = [] if prog is None else prog.named(KERNEL)
    if any(r.counts.get(k, v) != v for r in spans for k, v in want.items()):
        return None
    lanes = [r.counts["lanes"] for r in spans if "lanes" in r.counts]
    if len(lanes) == n:
        return lanes
    return [run.traced_lanes() * spec.cam_samples / n] * n


def read(run):
    if run.large or not run.spec.n_lights:
        return None
    ops = readers.kernel_ops(run, KERNEL)
    if not ops:
        return None
    lanes = _launch_lanes(run, len(ops))
    if lanes is None:
        return None
    work = run.work()
    ms = sum(k1_lit.k1_lit_bound(run.spec, n, work)[0] for n in lanes)
    return 100.0 * ms / (sum(o.seconds for o in ops) * 1e3)
