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


# golden.preview's entries: the cell is out of BENCHMARK.json while its
# previews, host work nearly all, spread from run to run by more than the
# largest bound holds (PERF.md, section 7), and its harness is tested all
# the same
_LOOP = "image loop: integrator._image_loop, _render_chunks"
_ISSUE = ("sampler and wrapper: integrator.sample_pixels, "
          "megakernel.radiance_lanes")
_ENCODE = "request: the encode, io/native or color.to_srgb, and io/bmp"
PREVIEW = {
    "workloads": [{
        "name": "golden.preview", "config": "golden", "traffic": "preview",
        "chips": 1,
        "why": "closed loop, one client: 800x800 previews at 16 samples, 3 "
               "launches; the image loop's host work and the encode take "
               "96% of a preview, K1 does little"}],
    "end_to_end": [{
        "name": "preview_s_p95", "unit": "s", "better": "lower",
        "bound": 0.25, "source": "host_clock",
        "workloads": ["golden.preview"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": "lower", "source": source,
         "layer": layer, "moves": "preview_s_p95",
         "workloads": ["golden.preview"]}
        for name, unit, source, layer in (
            ("device_ops_per_image.preview", "ops", "device_trace", _LOOP),
            ("encode_ms.preview", "ms", "host_clock", _ENCODE),
            ("device_idle.preview", "fraction", "device_trace", "device"),
            ("loop_idle_ms.preview", "ms", "device_trace", _LOOP),
            ("issue_idle_ms.preview", "ms", "device_trace", _ISSUE),
            ("srgb_encode_ms.preview", "ms", "program_span", _ENCODE),
            ("fetch_mb.preview", "MB", "program_counter", _LOOP))],
}

# the cells out of BENCHMARK.json whose harness the tests still run
OUT = (FIT, PREVIEW)
OUT_CELLS = [w["name"] for out in OUT for w in out["workloads"]]


def with_out() -> dict:
    """BENCHMARK.json with the entries of the cells that are out added."""
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for out in OUT:
        man = {**man, **{k: man[k] + out[k] for k in out}}
    return man


def load(workload: str, seed: int):
    """A cell of BENCHMARK.json, or one that is out of it."""
    return manifest.load(workload, seed, manifest=with_out())


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
    one that is out of it, at a CPU test's size."""
    def make(workload: str, seed: int = 20261017, **kw):
        return small(load(workload, seed), **kw)
    return make
