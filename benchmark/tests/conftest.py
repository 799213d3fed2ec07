"""Fixtures of the benchmark's tests.  A case that needs the card carries
the ``cuda`` marker and asks for the ``card`` fixture, which decides
there, never at import, whether to skip."""

from __future__ import annotations

import copy
import json
import os

import pytest

from benchmark import manifest

# golden.fit's entries: the cell is out of BENCHMARK.json while the port's
# gradient parts from the reference on some seeds (PERF.md, section 7), and
# its harness is tested all the same
FIT = {
    "workloads": [{
        "name": "golden.fit", "config": "golden", "traffic": "fit",
        "chips": 1,
        "why": "closed loop: fitting steps at 1024x1024, 1 sample a pixel, "
               "every float leaf, Adam; the plain-path backward under "
               "autograd does most of the work"}],
    "end_to_end": [{
        "name": "step_s", "unit": "s", "better": "lower", "bound": 0.24,
        "source": "host_clock", "workloads": ["golden.fit"]}],
    "per_layer": [
        {"name": "backward_share.fit", "unit": "fraction", "better": "lower",
         "source": "program_span",
         "layer": "fitting: optim.loss_and_grad, the plain path under "
                  "autograd",
         "moves": "step_s", "workloads": ["golden.fit"]},
        {"name": "device_idle.fit", "unit": "fraction", "better": "lower",
         "source": "device_trace", "layer": "device", "moves": "step_s",
         "workloads": ["golden.fit"]}],
}


def with_fit() -> dict:
    """BENCHMARK.json with golden.fit's entries added."""
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    return {**man, **{k: man[k] + FIT[k] for k in FIT}}


def load(workload: str, seed: int):
    """A cell of BENCHMARK.json, or golden.fit."""
    return manifest.load(workload, seed, manifest=with_fit())


@pytest.fixture(autouse=True, scope="session")
def _threads():
    """One intra-op thread a worker under pytest-xdist, whose workers
    would otherwise share the cores many times over."""
    import os

    import torch

    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(1)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch sees no CUDA device")
    return torch.device("cuda", 0)


def small(bench, size: int = 16, samples: int = 8):
    """``bench`` cut to a size a CPU test holds: ``size``² pixels,
    ``samples`` a pixel (4 for a mix that states its own), small checks."""
    bench = copy.copy(bench)
    bench.config = dict(bench.config, width=size, height=size,
                        samples=samples, check_lanes=size * size * samples,
                        check_block=1 << 14, work_lanes=256)
    t = dict(bench.traffic, trace_requests=2)
    if t["kind"] == "fit":
        t.update(width=size, height=size)
    elif t.get("samples"):
        t["samples"] = 4
    bench.traffic = t
    return bench


@pytest.fixture
def small_cell():
    """``small_cell(workload, seed)``: a cell of ``BENCHMARK.json``, or
    golden.fit, at a CPU test's size."""
    def make(workload: str, seed: int = 20261017, **kw):
        return small(load(workload, seed), **kw)
    return make
