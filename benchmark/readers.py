"""What the metrics' readers (``benchmark/metrics/<name>.py``) share.

Each reader is ``read(run) -> float | None`` over a
:class:`benchmark.run.Run`; it returns None where its cell gives it
nothing to read, and the run then leaves the metric out.
"""

from __future__ import annotations

import glob
import os
import re

import numpy as np

from benchmark import manifest
from benchmark.yardstick import busy

_NAME = re.compile(r"\b(\w+)\s*\(")


def _kernel_name(text: str) -> str | None:
    """The name declared by the text that follows ``__global__``: the
    first identifier before a parenthesis, past ``__launch_bounds__(...)``
    and its nested parentheses."""
    while True:
        m = _NAME.search(text)
        if m is None:
            return None
        if m.group(1) != "__launch_bounds__":
            return m.group(1)
        depth, i = 0, m.end() - 1
        for i in range(m.end() - 1, len(text)):
            depth += {"(": 1, ")": -1}.get(text[i], 0)
            if depth == 0:
                break
        text = text[i + 1:]


def handwritten_kernels(root: str = manifest.ROOT) -> set:
    """The names of the port's hand-written kernels: every ``__global__``
    function of its CUDA sources."""
    names = set()
    for path in glob.glob(os.path.join(root, "raytrace_tpu_torch", "csrc",
                                       "*.cu*")):
        with open(path) as f:
            parts = f.read().split("__global__")[1:]
        names.update(n for n in map(_kernel_name, parts) if n)
    return names


def is_handwritten(op_name: str, names: set) -> bool:
    """Whether a device operation's name is one of ``names``' kernels (a
    template instance carries its arguments after the name)."""
    return any(re.search(rf"\b{n}\b", op_name) for n in names)


def idle(run):
    """1 - the device's busy seconds over the traced window's."""
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s


def p95(run):
    """95th percentile of the wall seconds of the window's requests."""
    lat = run.window.latencies
    return float(np.percentile(lat, 95)) if lat else None


def kernel_ops(run, name: str) -> list | None:
    """The traced launches of kernel ``name`` (a hand-written one), where
    the recording holds every launch that the port's counter saw."""
    tr = run.trace
    if tr is None:
        return None
    ops = [o for o in tr.ops if re.search(rf"\b{name}\b", o.name)]
    if not ops or len(ops) != run.launches.get(name):
        return None
    return ops


def under(intervals, spans) -> float:
    """Seconds of ``spans`` covered by ``intervals``."""
    return sum(busy.union_s(intervals, s.start, s.end) for s in spans)
