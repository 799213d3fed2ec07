"""Device-idle milliseconds a traced request while the program's innermost
span is a group's ``issue`` or a range inside it, such as the kernel
wrapper's (``benchmark.program_spans``): the host failing to keep ahead of
the card.  It serves ``issue_idle_ms.final`` and ``issue_idle_ms.preview``."""

from benchmark import program_spans


def read(run):
    prog = program_spans.read(run)
    return None if prog is None else prog.idle_ms()["issue"]
