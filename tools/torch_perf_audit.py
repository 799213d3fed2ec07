"""Perf audit of the port: a chain-length sweep of the golden path's
kernel, fitted by least squares, against the profiler's device time of the
same chain.

    python3 tools/torch_perf_audit.py [--trace DIR]

Counterpart of ``tools/perf_audit.py``.  Runs on one NVIDIA GPU and fails
without one.  The chain is k calls of ``render.megakernel.radiance_lanes``
on cornell_indirect's 2,097,152 lanes (1024x1024 pixels, 16 samples each:
K1, the linear megakernel), each with a seed of its own and a fresh one
every run; a chain is timed with CUDA events around it.  For k in 2, 4,
..., 64 the median of five interleaved runs, then the least-squares line
through (k, median): its slope is the marginal ms per launch, its
intercept the fixed cost of a chain
(``raytrace_tpu_torch/bench.py::measure_slope``, the port's one slope
method).
Then ``torch.profiler`` records the longest chain, and the device time of
K1's launches over k is set beside the slope.  Prints the card's name and
power limit, a table of the sweep, and one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

KS = (2, 4, 8, 16, 32, 64)
REPS = 5


def profiled_ms(chain, k: int, name_part: str):
    """(device ms per launch of the kernels whose name holds
    ``name_part``, launches recorded) over one chain of k under
    torch.profiler; the recording starts with 64 trivial kernels, since
    one made after large ones may lose its first device records."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from raytrace_tpu_torch.utils.profiling import is_range

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            scratch.add_(1.0)
        chain(k, 0)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name_part in e.key
            and not is_range(e)]
    us = sum(e.self_device_time_total for e in rows)
    return us / 1e3 / k, sum(e.count for e in rows), prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", default=None,
                    help="write the profiled chain's Chrome trace here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device: the audit measures the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from raytrace_tpu_torch.bench import measure_slope
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.scene.builder import load_scene_file

    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    sc = load_scene_file(cs.SCENE, device=device)
    spec = dataclasses.replace(sc.spec, width=1024, height=1024)
    n_s = 16
    lanes = [t.to(torch.int32)
             for t in cs.pixel_lanes(1024, (1 << 21) // n_s, n_s, 1, device)]
    n = lanes[0].shape[0]

    def chain(k, bias):
        for i in range(k):
            out = megakernel.radiance_lanes(sc.data, spec, *lanes, bias + i)
        return out.x

    slope, fixed, runs, busy = measure_slope(chain, KS, REPS)
    print(f"{smi}; {n} lanes a launch, {spec.max_depth + 2} rounds a lane")
    for k in KS:
        med = float(np.median(runs[k]))
        print(f"k={k:3d}: median {med:9.3f} ms ({med / k:7.4f} ms a launch "
              f"raw); runs {[round(x, 3) for x in sorted(runs[k])]}")
    dev, seen, prof = profiled_ms(chain, KS[-1], megakernel.KERNEL_LINEAR)
    if args.trace:
        os.makedirs(args.trace, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.trace, "audit.json"))
    print(json.dumps({
        "card": smi, "kernel": megakernel.KERNEL_LINEAR,
        "lanes_per_launch": n, "ks": list(KS), "reps": REPS,
        "slope_ms": slope, "fixed_ms": fixed, "device_busy": busy,
        "rays_per_s": n * (spec.max_depth + 2) / slope * 1e3,
        "profiler_device_ms": dev, "profiler_launches": seen,
        "launches_expected": KS[-1],
        "slope_over_device": slope / dev if dev > 0 else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
