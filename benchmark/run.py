"""Run one cell of the benchmark once, on the card.

    python3 -m benchmark.run --workload golden.final --seed 7 --seconds 30 --trace 0

The cell comes from ``BENCHMARK.json`` (:mod:`benchmark.manifest`).  Set-up
builds the scene, loads (and on a checkout's first run builds) the
port's kernels, and warms every shape the cell's requests use; then the
window runs requests for ``--seconds`` (:mod:`benchmark.drive`).  Once
the window has closed, the device's peak memory is read, the program's
state is freed, and what the window produced is held to the reference
(:mod:`benchmark.reference`): each number compared is printed beside its
limit, on standard error and under ``checks`` in the result.  With
``--trace 0`` the result carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a torch.profiler
recording of the window's first requests, the device's busy seconds and
a breakdown.  A render cell's result names the encoder that ran
(``encode``: ``native`` or ``torch``).  The last line of standard
output is the result.

Before it imports numpy, torch or the port, the process has glibc's
malloc keep what it frees (:func:`keep_freed_memory`), so that every
request's host arrays come from the same heap.  The run refuses to
measure without a card, and refuses to report once ``jax``, ``jaxlib``,
``flax`` or the JAX package ``raytrace_tpu`` is loaded.  The port keeps its kernel builds in ``raytrace_tpu_torch/build/``
inside the checkout.
"""

from __future__ import annotations

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")

# glibc's mallopt parameters
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_KEEP_BYTES = 1 << 30


def keep_freed_memory() -> bool:
    """Have glibc's malloc keep the memory the process frees, up to 1 GiB
    an allocation and at the heap's top, so that a request's large host
    arrays (a float64 image is 15-25 MB) are served again from the heap
    and not mapped, faulted in and returned each request.  On the card's
    host that mapping's cost swings from run to run (PERF.md §2).  False
    where the C library is not glibc or refuses a setting."""
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c"))
        mallopt = libc.mallopt
    except (OSError, AttributeError, TypeError):
        return False
    return bool(mallopt(_M_MMAP_THRESHOLD, _KEEP_BYTES)
                and mallopt(_M_TRIM_THRESHOLD, _KEEP_BYTES))


class Run:
    """What a metric's reader reads: the cell, its window, its set-up
    seconds and, in a traced run, the recording."""

    def __init__(self, bench, cell, setup_s: float):
        self.bench, self.cell, self.setup_s = bench, cell, setup_s
        self.window = cell.window
        self.trace = None
        self.launches = {}     # the port's launch counters over the trace
        self._work = None

    @property
    def spec(self):
        return self.bench.reference.spec(self.bench.ref)

    @property
    def large(self) -> bool:
        from benchmark.yardstick.work import LARGE_ABOVE
        return self.bench.reference.n_objects(self.bench.ref) > LARGE_ABOVE

    def traced_lanes(self) -> int:
        return self.window.traced * self.cell.lanes()

    def work(self) -> dict:
        """What a sample of this cell's lanes needs, counted on the
        reference's paths (its ``work``)."""
        if self._work is None:
            import numpy as np
            import torch

            c, ref = self.cell, self.bench.reference
            rng = np.random.default_rng([self.bench.seed % (1 << 64), 5])
            n = self.bench.config["work_lanes"]
            pix = rng.integers(0, c.width * c.height, n)
            lanes = tuple(torch.as_tensor(a, device=c.device) for a in (
                pix % c.width, pix // c.width, rng.integers(0, c.spp, n)))
            lv = ref.leaves(self.bench.ref, c.device, torch.float32)
            self._work = ref.work(self.bench.ref, lv, lanes,
                                  int(rng.integers(0, 2 ** 31 - 1)),
                                  c.width, c.height, self.large)
        return self._work


def _device(torch, device, chips: int, peak: int, trace) -> dict:
    out = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": peak}
    if trace is not None:
        out["busy_s"] = trace.busy_s
        out["window_s"] = trace.window_s
    return out


def run_cell(bench, device, seconds: float, trace: bool,
             started: float = _STARTED) -> dict:
    """One run of ``bench``'s cell on ``device``: the result's object,
    with ``checks`` last."""
    import torch

    from benchmark import manifest
    from benchmark.trace import Recording, Spans

    spans = Spans()
    cell = bench.kind(bench, device, spans)
    cell.setup()
    cell.sync()
    setup_s = time.perf_counter() - started
    run = Run(bench, cell, setup_s)

    from raytrace_tpu_torch.ops import _build

    rec = Recording(spans, device) if trace else None
    n_traced = bench.traffic["trace_requests"] if trace else 0
    t0 = time.perf_counter()
    while True:
        if rec is not None and len(cell.window.latencies) == 0:
            rec.start()
            before = dict(_build.LAUNCHES)
        cell.request(cell.next_seed())
        done = len(cell.window.latencies)
        if rec is not None and done == n_traced:
            run.trace = rec.stop()
            run.launches = {k: v - before[k] for k, v in
                            _build.LAUNCHES.items()}
            cell.window.traced = done
            rec = None
        if rec is None and time.perf_counter() - t0 >= seconds:
            break
    cell.window.elapsed = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    cell.free()

    checks = cell.check()
    limits = bench.limits
    correct = all(k in limits and v <= limits[k] for k, v in checks.items())

    wanted = bench.per_layer if trace else bench.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.reader(m["name"], bench.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(cell.window.latencies),
              "failed": 0, "metrics": metrics,
              "device": _device(torch, device, bench.chips, peak, run.trace)}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    if cell.window.encode_path is not None:
        result["encode"] = cell.window.encode_path   # which encoder ran
    result["checks"] = {k: {"value": _number(v), "limit": limits.get(k)}
                        for k, v in checks.items()}
    return result


def _number(v):
    """A JSON number, or a string where it is not a finite one."""
    return v if math.isfinite(v) else str(v)


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark refuses."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if not keep_freed_memory():
        print("warning: malloc's thresholds not set: host arrays are "
              "mapped anew each request", file=sys.stderr)

    from benchmark import manifest

    bench = manifest.load(args.workload, args.seed)
    import raytrace_tpu_torch  # noqa: F401 -- the program under test
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < bench.chips:
        print(f"error: {bench.name} needs {bench.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    result = run_cell(bench, device, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"error: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 1
    if "encode" in result:
        print(f"encode {result['encode']}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
