"""Median, over the traced requests, of a request's summed ``srgb_encode``
span milliseconds: the program's own clock around its encoder, native or
``color.to_srgb`` (``benchmark.program_spans``).  It serves
``srgb_encode_ms.final`` and ``srgb_encode_ms.preview``."""

import statistics

from benchmark import program_spans


def read(run):
    prog = program_spans.traced(run)
    if prog is None:
        return None
    sums = [sum(r.end_ns - r.start_ns for r in req if r.name == "srgb_encode")
            for req in prog.per_request()]
    return statistics.median(sums) / 1e6 if any(sums) else None
