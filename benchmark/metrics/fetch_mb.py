"""The image loop's device-to-host bytes a traced request, in 10^6 bytes:
the ``bytes`` that each ``fetch`` span counted (``benchmark.program_spans``).
It serves ``fetch_mb.final`` and ``fetch_mb.preview``."""

from benchmark import program_spans


def read(run):
    prog = program_spans.traced(run)
    if prog is None:
        return None
    return sum(r.counts["bytes"] for r in prog.named("fetch")) / 1e6 \
        / prog.requests
