"""The program's spans on the recording's clock (``benchmark.program_spans``)
and the four metrics that read them, on a synthetic recording: two
requests, two groups each, the program's record at a known offset from the
recording's clock."""

from __future__ import annotations

import dataclasses
import types

import pytest

from benchmark import manifest, program_spans
from benchmark.trace import Op, Trace
from raytrace_tpu_torch.utils.profiling import Record

OFFSET_US = 1234.5           # recording time of the program's base
BASE_NS = 1_790_000_000_000_000_000
REQUEST_US = 1000.0
KERNEL = "void (anonymous namespace)::megakernel_linear<false, 0>(Params)"
READERS = ("loop_idle_ms", "issue_idle_ms", "srgb_encode_ms", "fetch_mb")


def _ns(t_us: float) -> int:
    """A recording time as the program's clock reads it."""
    return BASE_NS + round((t_us - OFFSET_US) * 1e3)


class _Record:
    """Makes the program's records of one run: ids in the order they
    open, parents from the spans open around them."""

    def __init__(self):
        self.records, self.stack = [], []

    def span(self, name, a, b, children=(), counts=None):
        rec = Record(name, len(self.records),
                     self.stack[-1].id if self.stack else None, _ns(a), _ns(b),
                     counts or {})
        self.records.append(rec)
        self.stack.append(rec)
        for child in children:
            self.span(*child)
        self.stack.pop()


def _group(r, at):
    """One group from ``r + at``: issue (the kernel wrapper's range inside
    it), fetch, accumulate, progress."""
    t = r + at
    return [("issue", t + 10, t + 110,
             [("megakernel_linear", t + 50, t + 90)]),
        ("fetch", t + 110, t + 300, (), {"bytes": 768}),
        ("accumulate", t + 300, t + 350),
        ("progress", t + 350, t + 360)]


def synthetic(kernel_at: float = 95.0, drift_us: float = 0.0,
              stall_us: float = 0.0, device_early_us=(0.0,) * 4):
    """A recording of two requests and the program's record of them.

    In each request (times from its start, microseconds): the image loop
    2-799, groups at 0 and 400 (issue +10..+110 holding the kernel
    wrapper's range +50..+90; fetch to +300; accumulate to
    +350; progress to +360), the encode 820-900; the kernel and a copy
    +95..+250 and +250..+290 of each group.  The benchmark's group
    boundaries lie at the middle of each progress call.  ``drift_us``
    moves the k-th progress call k times that far on the program's clock
    (two clocks that drift apart); ``stall_us`` lengthens the first
    progress call (a host that stalls inside it); ``device_early_us``
    moves each group's device records that far earlier (a device clock
    that drifts from the host's)."""
    rec = _Record()
    spans, ops = [], []
    for k in range(2):
        r = k * REQUEST_US
        groups = _group(r, 0) + _group(r, 400)
        rec.span("image_loop", r + 2, r + 799, groups)
        rec.span("srgb_encode", r + 820, r + 900)
        spans.append(Op("request", r, r + REQUEST_US))
        cuts = [r + 1, r + 355, r + 755, r + 800]
        spans += [Op("group", a + (1 if i else 0), b - 1)
                  for i, (a, b) in enumerate(zip(cuts, cuts[1:]))]
        spans.append(Op("encode", r + 801, r + 999))
        for g in (0, 400):
            e = device_early_us[2 * k + g // 400]
            ops.append(Op(KERNEL, r + g + kernel_at - e, r + g + 250 - e))
            ops.append(Op("Memcpy DtoH (Device -> Pageable)",
                          r + g + 250 - e, r + g + 290 - e))
    progress = [x for x in rec.records if x.name == "progress"]
    for k, p in enumerate(progress):
        p.start_ns += round(k * drift_us * 1e3)
        p.end_ns += round(k * drift_us * 1e3)
    progress[0].end_ns += round(stall_us * 1e3)
    trace = Trace(ops, spans, [], (0.0, 2 * REQUEST_US))
    return trace, rec.records


def _run(trace, records, monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    return types.SimpleNamespace(trace=trace,
                                 window=types.SimpleNamespace(traced=2))


def _read(name, run):
    return manifest.reader(name + ".final")(run)


def test_offset_recovered_and_idle_split_exact(monkeypatch):
    trace, records = synthetic()
    prog = program_spans.align(trace, records, 2)
    assert prog is not None
    for r in records:
        assert prog.at(r.start_ns) == pytest.approx(
            (r.start_ns - BASE_NS) / 1e3 + OFFSET_US, abs=1e-6)
    wrapper = prog.named("megakernel_linear")[0]
    assert prog.at(wrapper.start_ns) == pytest.approx(50.0, abs=1e-6)
    run = _run(trace, records, monkeypatch)
    # idle in a request: 0-95 (the loop's 2-10, the issue's 10-95), 290-495
    # (fetch, accumulate, progress, loop 290-410; the issue's 410-495) and
    # 690-1000 (the loop's to 799; the encode and the benchmark's own time
    # after it count for neither)
    assert _read("loop_idle_ms", run) == pytest.approx(
        (8 + 120 + 109) / 1e3)
    assert _read("issue_idle_ms", run) == pytest.approx((85 + 85) / 1e3)
    assert _read("fetch_mb", run) == pytest.approx(2 * 768 / 1e6)
    assert _read("srgb_encode_ms", run) == pytest.approx(0.08)


def test_stalled_progress_call_moves_nothing(monkeypatch):
    """A progress call that the host stalled inside for a millisecond is
    one anchor off by half that: the offset is exact, and every reader
    reads, as without it but for the loop's idle time, which the longer
    call changes."""
    trace, records = synthetic()
    want = {name: _read(name, _run(trace, records, monkeypatch))
            for name in READERS}
    trace, records = synthetic(stall_us=1000.0)
    prog = program_spans.align(trace, records, 2)
    assert prog is not None
    assert prog.offset_us == pytest.approx(
        (records[0].start_ns - BASE_NS) / 1e3 + OFFSET_US, abs=1e-6)
    run = _run(trace, records, monkeypatch)
    assert _read("loop_idle_ms", run) is not None
    for name in READERS[1:]:
        assert _read(name, run) == pytest.approx(want[name]), name


def test_device_clock_drift_corrected(monkeypatch):
    """Device records that start up to 4 ms before the wrapper ranges that
    launched them, early by 0.1 ms more in each group (a device clock
    drifting from the host's): each group is moved by the least shift that puts its
    kernel after its wrapper's start, so the readers read as without the
    drift but for each kernel's own lead (45 us), which the shift takes."""
    trace, records = synthetic()
    want = {name: _read(name, _run(trace, records, monkeypatch))
            for name in READERS}
    early = (3700.0, 3800.0, 3900.0, 4000.0)
    trace, records = synthetic(device_early_us=early)
    prog = program_spans.align(trace, records, 2)
    assert prog is not None
    assert prog.shifts == pytest.approx([45.0 - e for e in early])
    run = _run(trace, records, monkeypatch)
    # per request: two groups' issue idle shorter by 45 us, loop idle longer
    assert _read("issue_idle_ms", run) == pytest.approx(
        want["issue_idle_ms"] - 2 * 45 / 1e3)
    assert _read("loop_idle_ms", run) == pytest.approx(
        want["loop_idle_ms"] + 2 * 45 / 1e3)
    for name in ("fetch_mb", "srgb_encode_ms"):
        assert _read(name, run) == pytest.approx(want[name]), name
    # a clock the profiler keeps whole is left as it is
    assert program_spans.align(*synthetic(), 2).shifts == [0.0] * 4


def test_lost_kernel_record(monkeypatch):
    """A kernel record the profiler lost leaves its group with fewer kernel
    records than wrapper ranges: the group is still put on the host's
    clock, and the idle readers read (the lost kernel's time as idle)."""
    trace, records = synthetic()
    trace.ops.pop(0)
    prog = program_spans.align(trace, records, 2)
    assert prog is not None and prog.shifts == [0.0] * 4
    run = _run(trace, records, monkeypatch)
    assert all(_read(name, run) is not None for name in READERS)


def test_earlier_recording_left_out(monkeypatch):
    """Spans that an earlier recording in the process left in the record
    (a render and its encode before the traced requests) are left out:
    every reader reads as it does without them."""
    trace, records = synthetic()
    clean = _run(trace, records, monkeypatch)
    want = {name: _read(name, clean) for name in READERS}
    stale = _Record()
    stale.span("image_loop", -9000, -8201,
               _group(-9000, 0) + _group(-9000, 400))
    stale.span("srgb_encode", -8180, -8100)
    n = len(stale.records)
    later = [dataclasses.replace(
        r, id=r.id + n, parent=None if r.parent is None else r.parent + n)
        for r in records]
    run = _run(trace, stale.records + later, monkeypatch)
    for name in READERS:
        assert _read(name, run) == pytest.approx(want[name]), name


def test_every_metric_file_serves_both_cells():
    for name in READERS:
        for cell in ("final", "preview"):
            assert callable(manifest.reader(f"{name}.{cell}"))


# the readers that put device time beside the program's spans, and those
# that read the program's record alone
ALIGNED, OWN = READERS[:2], READERS[2:]


@pytest.mark.parametrize("fault, refusing", [
    ("anchors", ALIGNED), ("kernel", ALIGNED), ("kernels", ALIGNED),
    ("copies", ALIGNED),
    ("counts", ALIGNED), ("trace", READERS), ("record", READERS),
    ("requests", READERS)])
def test_readers_refuse(fault, refusing, monkeypatch):
    """Anchors that spread by more than 0.2 ms (clocks that drift apart by
    0.3 ms a progress call), a kernel record 100 us before its wrapper's
    range while its copy ends 10 us before its fetch (no shift puts both
    right), a group with a kernel record more than its wrapper ranges, a
    copy missing, a progress call missing: the idle readers
    return None, the others read.  No trace, a program that keeps no
    record, a count of requests unlike the record's: every reader returns
    None."""
    trace, records = synthetic(
        kernel_at=-50.0 if fault == "kernel" else 95.0,
        drift_us=300.0 if fault == "anchors" else 0.0)
    if fault == "copies":
        trace.ops.pop()
    if fault == "kernels":
        trace.ops.insert(1, Op(KERNEL, 100.0, 240.0))
    if fault == "counts":
        records = records[:-2]   # the last progress call and the encode
        assert records[-1].name == "accumulate"
    run = _run(trace, None if fault == "record" else records, monkeypatch)
    if fault == "trace":
        run.trace = None
    if fault == "requests":
        run.window.traced = 3
    for name in READERS:
        assert (_read(name, run) is None) == (name in refusing), name
    # the same run without the fault reads
    good = _run(*synthetic(), monkeypatch)
    assert all(_read(name, good) is not None for name in READERS)


def test_program_keeps_its_record():
    """The reader finds the port's record where the port keeps one."""
    assert isinstance(program_spans.program_records(), list)
