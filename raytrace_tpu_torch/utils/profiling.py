"""Profiler ranges for the render phases, the image loop and the encode,
and the program's own record of them.

PyTorch counterpart of :mod:`raytrace_tpu.utils.profiling`, which marks
each phase with ``jax.named_scope`` so that a ``--profile`` trace puts the
device's time under ``raygen``, ``intersect``, ``shade``, ``background``
and ``grad_psum``.  Here :func:`span` (and :func:`annotate`, its
decorator form) runs the code under ``torch.profiler.record_function(name)``
while a profiler records, and as it is otherwise: one check of the
profiler's state per call, where a ``record_function`` would make and
close a range on every call whether or not anything records.  The CLI's
``--profile`` writes such a trace (``torch.profiler``, Chrome's format).

While a profiler records, each span is also kept in memory
(:func:`recorded`): its name, its parent (the span open around it on the
same thread), its start and end in ``time.time_ns()``, and what it
counted (a fetch's ``bytes``, a wait's ``ahead``).  torch.profiler
converts its host and device records to the same Unix-epoch clock,
relative to the recording's start, so a reader of the trace can put the
program's spans beside the device's records once it knows that start.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

# the ranges of the render phases, as the JAX package names them, then
# the image loop's (render/integrator.py) and the encoders'
# (io/native.py, color.py)
RANGES = (RAYGEN, INTERSECT, SHADE, BACKGROUND, GRAD_PSUM, IMAGE_LOOP, ISSUE,
          WAIT, FETCH, ACCUMULATE, PROGRESS, CHECKPOINT, SRGB_ENCODE) = (
    "raygen", "intersect", "shade", "background", "grad_psum", "image_loop",
    "issue", "wait", "fetch", "accumulate", "progress", "checkpoint",
    "srgb_encode")


@dataclasses.dataclass(slots=True)
class Record:
    """One span as the program recorded it.  ``parent`` is the id of the
    span open around it on the same thread (None for an outermost one);
    times are ``time.time_ns()``; ``counts`` what the span's caller
    counted."""

    name: str
    id: int
    parent: int | None
    start_ns: int
    end_ns: int | None
    counts: dict


_records: list = []
_ids = itertools.count()
_open = threading.local()      # .stack: this thread's open records
_NOTHING = contextlib.nullcontext()


class _Span:
    """A ``record_function`` range and the record of it."""

    __slots__ = ("name", "counts", "range", "record")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def __enter__(self):
        self.range = record_function(self.name)
        self.range.__enter__()
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.record = Record(self.name, next(_ids),
                             stack[-1].id if stack else None, time.time_ns(),
                             None, self.counts)
        stack.append(self.record)
        _records.append(self.record)
        return self

    def __exit__(self, *exc):
        self.record.end_ns = time.time_ns()
        _open.stack.remove(self.record)
        return self.range.__exit__(*exc)


def span(name: str, **counts):
    """``record_function(name)`` and a :class:`Record` of it while a
    profiler records, else a context that does nothing.  ``counts`` are
    numbers kept with the record (``bytes=...``)."""
    if not _profiler_enabled():
        return _NOTHING
    return _Span(name, counts)


def recorded() -> list:
    """The spans recorded so far (:class:`Record`), in the order they
    opened."""
    return list(_records)


def clear() -> None:
    """Forget the spans recorded so far."""
    _records.clear()


def annotate(name: str):
    """Decorator: run the function under :func:`span` ``(name)``."""
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
    """Whether a profiler event is a record_function range (the ranges
    above and the kernel wrappers' ranges), whose device rows span the
    kernels they hold and are no device work of their own."""
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
