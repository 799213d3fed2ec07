"""Device-idle milliseconds a traced request while the program's innermost
span is the image loop's own (``image_loop``, ``fetch``, ``accumulate``,
``progress``, ``checkpoint``: ``benchmark.program_spans``); it serves
``loop_idle_ms.final`` and ``loop_idle_ms.preview``."""

from benchmark import program_spans


def read(run):
    prog = program_spans.read(run)
    return None if prog is None else prog.idle_ms()["loop"]
