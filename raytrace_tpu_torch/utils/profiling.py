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


def is_range(event) -> bool:
    """Whether a profiler event is a record_function range (the phase
    ranges above and the kernel wrappers' ranges), whose device rows span
    the kernels they hold and are no device work of their own."""
    from raytrace_tpu_torch.ops import _build

    return bool(getattr(event, "is_user_annotation", False)) or (
        event.key in RANGES + _build.KERNELS)


def device_busy_ms(fn) -> float:
    """Device time (ms) of every kernel and copy that ``fn`` launches on
    the current card, from torch.profiler.  The recording starts with 64
    trivial kernels, which a recording made after large ones may lose in
    place of ``fn``'s; they are the first 64 device records and are left
    out of the sum."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            scratch.add_(1.0)
        fn()
        torch.cuda.synchronize()
    records = sorted((e for e in prof.events()
                      if e.device_type == DeviceType.CUDA and not is_range(e)),
                     key=lambda e: e.time_range.start)
    return sum(e.device_time_total for e in records[64:]) / 1e3
