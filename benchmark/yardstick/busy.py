"""Device time from a torch.profiler recording.

A frozen copy, at commit 6033020, of the arithmetic of
``raytrace_tpu_torch/utils/profiling.py::device_busy_ms`` and
``is_range``: the device records are the profiler's CUDA events that are
not ``record_function`` ranges (a range's device row spans the kernels
it holds and is no work of its own), in order of their start.
``benchmark/tests/test_harness_yardstick.py`` pins it to the original.
The benchmark's busy time is the union of these records' intervals, so
that work that overlaps is counted once.
"""

from __future__ import annotations

# the port's range names at commit 6033020: its render phases and the
# kernel wrappers' ranges, named by their kernels
RANGES = ("raygen", "intersect", "shade", "background", "grad_psum",
          "megakernel_linear", "megakernel_tree", "scan_hit", "skybox",
          "ring_shade")


def is_range(event) -> bool:
    return bool(getattr(event, "is_user_annotation", False)) or (
        event.key in RANGES)


def device_records(events) -> list:
    """The device records of a recording's events, by start."""
    from torch.autograd import DeviceType

    return sorted((e for e in events
                   if e.device_type == DeviceType.CUDA and not is_range(e)),
                  key=lambda e: e.time_range.start)


def records_ms(records, skip: int = 0) -> float:
    """The summed device time (ms) of the records after the first
    ``skip``."""
    return sum(e.device_time_total for e in records[skip:]) / 1e3


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds covered by ``intervals`` ((start, end) in microseconds),
    clipped to [lo, hi], each moment counted once."""
    total, cur_lo, cur_hi = 0.0, None, None
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if cur_hi is None or a > cur_hi:
            if cur_hi is not None:
                total += cur_hi - cur_lo
            cur_lo, cur_hi = a, b
        else:
            cur_hi = max(cur_hi, b)
    if cur_hi is not None:
        total += cur_hi - cur_lo
    return total / 1e6
