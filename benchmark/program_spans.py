"""The program's own spans in a traced run, put on the recording's clock.

While a profiler records, the port keeps a record of its spans in memory
(``raytrace_tpu_torch.utils.profiling.recorded``): the image loop
(``image_loop``, each group's ``issue``, ``fetch``, ``accumulate``,
``progress`` and ``checkpoint``), the ranges inside them (a kernel
wrapper's, named after its kernel), and the encoders' ``srgb_encode``,
each with its parent and what it counted, stamped with
``time.time_ns()``.  The record is the process's: a run's traced
requests are its last ``image_loop`` roots, and what the record holds
before the first of them (an earlier recording's) is left out.  A count
or a span's own length needs nothing more (:func:`traced`).

Device time against the program's spans needs two clocks put together
(:func:`read`).  The recording's host clock is the program's, relative
to the recording's start, which :class:`benchmark.trace.Trace` does not
keep.  So the offset between the two is estimated from anchors: the
benchmark closes one ``group`` span and opens the next inside every
``progress`` call, and the offset is the median, over the traced
progress calls, of that boundary less the middle of the program's
``progress`` span.  No offset is taken where the anchors disagree (half
of them lie farther than 0.1 ms from their median; a progress call the
host stalled inside moves neither).

The recording's device clock is not always its host clock: in about one
recording in seven on an H100 (torch 2.11) the profiler's own kernel
records start up to 4 ms before its own ``cudaLaunchKernel`` records,
by an error that grows through the recording.  So each group's device
records (those after the last group's device-to-host copy, up to and
with its own) are moved by the least shift that puts every hand-written
kernel's record (the group's k-th) after the start of the k-th of the
program's ranges named after a hand-written kernel in the group's
``issue`` (the wrapper's, which launched it) and the group's copy before
the end of the ``fetch`` that waited for it; none where the profiler's
records already do.  No shift is taken where none does both.

A program that keeps no such record (one older than it) gives nothing
here, and its metrics are left out of the run's line.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import statistics

from benchmark import readers
from benchmark.trace import Op

# the innermost program spans whose idle device time is the image loop's
LOOP = ("image_loop", "fetch", "accumulate", "progress", "checkpoint")
# the span whose idle device time, with the ranges inside it, is the
# sampler's and the wrapper's: the host issuing a group's launches and
# failing to keep ahead of the card
ISSUE = "issue"
# the widest spread of the anchors' offsets (microseconds) that is taken
# as one clock: the width of the band around their median that holds half
# of them, so that a host that stalls inside a few progress calls moves no
# offset and refuses no run
ANCHOR_SPREAD_US = 200.0
# the device operation that ends a group: its fetch's copy
COPY = "Memcpy DtoH"


def program_records() -> list | None:
    """The program's recorded spans, or None where the program keeps no
    record."""
    from raytrace_tpu_torch.utils import profiling

    recorded = getattr(profiling, "recorded", None)
    return None if recorded is None else recorded()


@dataclasses.dataclass
class Traced:
    """The program's closed spans of the traced requests."""

    records: list
    requests: int

    def named(self, name: str) -> list:
        return [r for r in self.records if r.name == name]

    def per_request(self) -> list:
        """The records grouped by traced request: a request starts at each
        root ``image_loop`` span and holds every span until the next one
        (its encode, an outermost span of its own, too)."""
        out = []
        for r in self.records:
            if r.name == "image_loop" and r.parent is None:
                out.append([])
            if out:
                out[-1].append(r)
        return out


def traced_records(records, requests: int) -> Traced | None:
    """The closed records of the last ``requests`` traced requests (from
    the first of the last ``requests`` root ``image_loop`` spans on), or
    None where the record holds fewer roots."""
    records = [r for r in records if r.end_ns is not None]
    roots = [r for r in records if r.name == "image_loop" and r.parent is None]
    if not requests or len(roots) < requests:
        return None
    first = roots[-requests].start_ns
    return Traced([r for r in records if r.start_ns >= first], requests)


@dataclasses.dataclass
class Program(Traced):
    """The traced requests' spans and the device's operations on one
    clock: the recording's."""

    base_ns: int = 0        # the earliest start: times are taken from it
    offset_us: float = 0.0  # recording time = (t - base_ns) / 1e3 + offset_us
    ops: list = dataclasses.field(default_factory=list)  # device, moved
    window: tuple = (0.0, 0.0)
    shifts: list = dataclasses.field(default_factory=list)  # a group's, us

    def at(self, t_ns: int) -> float:
        """A program time on the recording's clock (microseconds)."""
        return (t_ns - self.base_ns) / 1e3 + self.offset_us

    def segments(self) -> list:
        """The recording's time cut at every span's edges, as (start, end,
        innermost span open there) in order; a time no span covers is in
        no segment."""
        edges = []
        for r in self.records:
            edges.append((self.at(r.start_ns), 1, r.id, r))
            edges.append((self.at(r.end_ns), 0, -r.id, r))
        edges.sort(key=lambda e: e[:3])    # at a tie: closes, outer first
        out, stack, last = [], [], None
        for t, opens, _, r in edges:
            if stack and t > last:
                out.append((last, t, stack[-1]))
            last = t
            if opens:
                stack.append(r)
            else:
                stack.remove(r)
        return out

    def idle_us(self) -> collections.Counter:
        """The device's idle microseconds in the traced window, by the
        innermost program span open at the time."""
        gaps, last = [], self.window[0]
        for o in sorted(self.ops, key=lambda o: o.start):
            if o.start > last:
                gaps.append((last, o.start))
            last = max(last, o.end)
        if self.window[1] > last:
            gaps.append((last, self.window[1]))
        out = collections.Counter()
        segs, i = self.segments(), 0
        for a, b in gaps:
            while i < len(segs) and segs[i][1] <= a:
                i += 1
            j = i
            while j < len(segs) and segs[j][0] < b:
                lo, hi, r = segs[j]
                if min(b, hi) > max(a, lo):
                    out[r.id] += min(b, hi) - max(a, lo)
                j += 1
        return out

    def idle_ms(self) -> dict:
        """Idle device milliseconds a traced request by where the program
        was: ``loop`` under the image loop's own spans (:data:`LOOP`),
        ``issue`` under a group's ``issue`` or a range inside it."""
        by_id = {r.id: r for r in self.records}

        def in_issue(r):
            while r is not None:
                if r.name == ISSUE:
                    return True
                r = by_id.get(r.parent)
            return False

        out = {"loop": 0.0, "issue": 0.0}
        for i, us in self.idle_us().items():
            r = by_id[i]
            if r.name in LOOP:
                out["loop"] += us / 1e3 / self.requests
            elif in_issue(r):
                out["issue"] += us / 1e3 / self.requests
        return out


def _anchors(trace) -> list:
    """The benchmark's group boundaries, in order: in each traced request,
    the middle between one ``group`` span's end and the next one's
    start."""
    groups = sorted(trace.named("group"), key=lambda s: s.start)
    out = []
    for req in sorted(trace.named("request"), key=lambda s: s.start):
        inside = [g for g in groups
                  if req.start <= g.start and g.end <= req.end]
        out += [(a.end + b.start) / 2 for a, b in zip(inside, inside[1:])]
    return out


def _device_on_host(prog: Program, trace) -> tuple | None:
    """The trace's device operations with each group's moved onto the
    host's clock, and each group's shift (microseconds), or None: counts
    of copies, ``issue`` spans and ``fetch`` spans that differ, a group
    with more kernel records than wrapper ranges, or a group that no shift
    puts after its wrappers' starts and before its fetch's end.  A group's
    k-th kernel record is held to the k-th wrapper range in its ``issue``:
    where the profiler lost a record, to one that opened earlier."""
    names = readers.handwritten_kernels()
    wrappers = sorted(r.start_ns for r in prog.records if r.name in names)
    issues = sorted(prog.named(ISSUE), key=lambda r: r.start_ns)
    fetches = sorted(prog.named("fetch"), key=lambda r: r.start_ns)
    groups, cur = [], []
    for o in sorted(trace.ops, key=lambda o: o.start):
        cur.append(o)
        if o.name.startswith(COPY):
            groups.append(cur)
            cur = []
    if not len(groups) == len(issues) == len(fetches):
        return None
    if cur and groups:        # after the last copy: moved with its group
        groups[-1] += cur
    ops, shifts = [], []
    for group, issue, fetch in zip(groups, issues, fetches):
        launched = [prog.at(t) for t in wrappers
                    if issue.start_ns <= t <= issue.end_ns]
        kernels = [o.start for o in group
                   if readers.is_handwritten(o.name, names)]
        if len(kernels) > len(launched):
            return None
        copy = max(o.end for o in group if o.name.startswith(COPY))
        lo = copy - prog.at(fetch.end_ns)
        hi = min((k - w for k, w in zip(kernels, launched)), default=math.inf)
        if lo > hi:
            return None
        shift = min(max(0.0, lo), hi)
        shifts.append(shift)
        ops += [Op(o.name, o.start - shift, o.end - shift) for o in group]
    return ops, shifts


def align(trace, records, requests: int) -> Program | None:
    """The program's records of ``requests`` traced requests
    (:func:`traced_records`) and the device's operations on the recording
    of ``trace``, or None where they cannot be put on one clock: fewer
    roots than requests, a count of anchors that differs, anchors that
    spread by more than :data:`ANCHOR_SPREAD_US` (twice their median
    distance from their median), or device records that no shift a group
    puts between the program's spans (:func:`_device_on_host`)."""
    got = traced_records(records, requests)
    if got is None:
        return None
    base = min(r.start_ns for r in got.records)
    progress = sorted(got.named("progress"), key=lambda r: r.start_ns)
    anchors = _anchors(trace)
    if not anchors or len(anchors) != len(progress):
        return None
    offsets = [a - (p.start_ns - base + p.end_ns - base) / 2e3
               for a, p in zip(anchors, progress)]
    mid = statistics.median(offsets)
    if 2 * statistics.median(abs(o - mid) for o in offsets) > ANCHOR_SPREAD_US:
        return None
    prog = Program(got.records, requests, base, mid, window=trace.window)
    moved = _device_on_host(prog, trace)
    if moved is None:
        return None
    prog.ops, prog.shifts = moved
    return prog


def traced(run) -> Traced | None:
    """The program's spans of ``run``'s traced requests, or None (no
    trace, no record, or fewer requests in it)."""
    if run.trace is None:
        return None
    records = program_records()
    if records is None:
        return None
    return traced_records(records, run.window.traced)


def read(run) -> Program | None:
    """The program's spans of ``run``'s traced requests and the device's
    operations on its recording's clock, or None (no trace, no record, or
    no agreement)."""
    if run.trace is None:
        return None
    records = program_records()
    if records is None:
        return None
    return align(run.trace, records, run.window.traced)
