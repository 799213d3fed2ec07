"""The traced run's recording and what the benchmark reads from it.

A ``--trace 1`` run records a few requests of its window with
torch.profiler (the host and the device).  The benchmark marks its own
spans around its calls into the program (``bench::request``, the image
loop's groups between two progress calls, the encode, a fitting step's
``loss_and_grad``, Adam's step and the loss's fetch); the program's
autograd backward shows as the engine's ``evaluate_function`` ranges.
From these come the device's busy seconds in the traced window, the
device operations by time, and the idle gaps, each labelled by what the
host was doing when it began.
"""

from __future__ import annotations

import collections
import dataclasses

from benchmark.yardstick import busy

PREFIX = "bench::"
BACKWARD = "autograd::engine::evaluate_function"


class Spans:
    """The benchmark's host spans: ``record_function`` ranges while a
    recording runs, nothing otherwise."""

    def __init__(self):
        self.on = False
        self._open = {}

    def enter(self, name: str):
        if self.on:
            from torch.autograd.profiler import record_function
            rf = record_function(PREFIX + name)
            rf.__enter__()
            self._open[name] = rf

    def exit(self, name: str):
        rf = self._open.pop(name, None)
        if rf is not None:
            rf.__exit__(None, None, None)


class Recording:
    """A torch.profiler recording of the host and the card.  It starts
    with 64 trivial kernels: a recording made after large ones can lose
    its first device records, and then loses theirs."""

    def __init__(self, spans: Spans, device):
        self.spans, self.device = spans, device
        self.prof = None

    def _sync(self):
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        scratch = torch.zeros(1, device=self.device)
        for _ in range(64):
            scratch.add_(1.0)
        self._sync()
        self.spans.on = True

    def stop(self) -> "Trace":
        self._sync()
        self.spans.on = False
        self.prof.stop()
        return Trace.of(self.prof.events())


def _merged(intervals) -> list:
    """Overlapping (start, end) intervals merged, in order."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


@dataclasses.dataclass
class Op:
    name: str
    start: float   # microseconds, the recording's clock
    end: float

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def is_kernel(self) -> bool:
        return not self.name.startswith(("Memcpy", "Memset"))


@dataclasses.dataclass
class Trace:
    ops: list          # device operations (Op) in the traced window
    spans: list        # the benchmark's spans (Op), name without prefix
    backward: list     # the autograd engine's ranges, merged (start, end)
    window: tuple      # (start, end): the traced requests

    @classmethod
    def of(cls, events) -> "Trace":
        from torch.autograd import DeviceType

        spans, backward = [], []
        for e in events:
            if e.device_type == DeviceType.CUDA:
                continue
            if e.name.startswith(PREFIX):
                spans.append(Op(e.name[len(PREFIX):], e.time_range.start,
                                e.time_range.end))
            elif e.name.startswith(BACKWARD):
                backward.append((e.time_range.start, e.time_range.end))
        reqs = [s for s in spans if s.name in ("request", "step")]
        window = ((min(s.start for s in reqs), max(s.end for s in reqs))
                  if reqs else (0.0, 0.0))
        ops = [Op(e.name, e.time_range.start, e.time_range.end)
               for e in busy.device_records(events)
               if window[0] <= e.time_range.start < window[1]]
        return cls(ops, spans, _merged(backward), window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return busy.union_s([(o.start, o.end) for o in self.ops],
                            *self.window)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def label(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span,
        and within a fitting step's ``loss_and_grad`` its backward or
        forward."""
        inner = None
        for s in self.spans:
            if s.start <= t < s.end and (inner is None
                                         or s.end - s.start
                                         < inner.end - inner.start):
                inner = s
        if inner is None:
            return "outside"
        if inner.name == "loss_and_grad":
            return ("backward" if any(a <= t < b for a, b in self.backward)
                    else "forward")
        return inner.name

    def _idle(self, a: float, b: float, gaps) -> None:
        """Add the idle interval [a, b) to ``gaps``, each part under what
        the host was doing then."""
        cuts = sorted({a, b} | {x for s in self.spans for x in (s.start, s.end)
                                if a < x < b}
                      | {x for iv in self.backward for x in iv if a < x < b})
        for lo, hi in zip(cuts, cuts[1:]):
            gaps[self.label(lo)] += (hi - lo) / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each as [name, seconds]."""
        by_op = collections.Counter()
        for o in self.ops:
            by_op[o.name[:160]] += o.seconds
        gaps = collections.Counter()
        last = self.window[0]
        for o in sorted(self.ops, key=lambda o: o.start):
            if o.start > last:
                self._idle(last, o.start, gaps)
            last = max(last, o.end)
        if self.window[1] > last:
            self._idle(last, self.window[1], gaps)
        return {"device_ops": [[n, s] for n, s in by_op.most_common(top)],
                "idle_gaps": [[n, s] for n, s in gaps.most_common(top)]}
