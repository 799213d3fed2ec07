"""Profiler ranges for the render phases.

PyTorch counterpart of :mod:`raytrace_tpu.utils.profiling`, which marks
each phase with ``jax.named_scope`` so that a ``--profile`` trace puts the
device's time under ``raygen``, ``intersect``, ``shade``, ``background``
and ``grad_psum``.  Here :func:`annotate` runs the function under
``torch.profiler.record_function(name)`` while a profiler records, and
calls it as it is otherwise: one check of the profiler's state per call,
where a ``record_function`` would make and close a range on every call
whether or not anything records.  The CLI's ``--profile``
writes such a trace (``torch.profiler``, Chrome's format).
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# the ranges of the render phases, as the JAX package names them
RANGES = RAYGEN, INTERSECT, SHADE, BACKGROUND, GRAD_PSUM = (
    "raygen", "intersect", "shade", "background", "grad_psum")


def span(name: str):
    """``record_function(name)`` while a profiler records, else a context
    that does nothing."""
    if not _profiler_enabled():
        return contextlib.nullcontext()
    return record_function(name)


def annotate(name: str):
    """Decorator: run the function under ``record_function(name)`` while
    a profiler records."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def trace_activities(device: torch.device) -> list:
    """What a ``--profile`` recording on ``device`` records: the host and,
    on a card, the device's kernels and copies."""
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts
