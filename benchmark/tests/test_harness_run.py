"""A run's last line, and what a run without a card does."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests.conftest import OUT_CELLS

ROOT = manifest.ROOT
CELLS = [w["name"] for w in json.load(
    open(os.path.join(ROOT, "BENCHMARK.json")))["workloads"]]


@pytest.mark.parametrize("workload", CELLS + OUT_CELLS)
def test_last_line_keys(small_cell, workload):
    bench = small_cell(workload)
    out = run.run_cell(bench, torch.device("cpu"), 0.2, False)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["attempted"] >= 1
    if bench.traffic["kind"] == "render":
        assert out["encode"] in ("native", "torch")
    assert set(out["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"]: m["unit"] for m in bench.end_to_end}
    assert {k: v["unit"] for k, v in out["metrics"].items()} == want
    for name, c in out["checks"].items():
        assert c["value"] <= c["limit"], name
    json.dumps(out, allow_nan=False)


def test_traced_run_keys(small_cell):
    out = run.run_cell(small_cell("golden.fit"), torch.device("cpu"), 0.2,
                       True)
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the CPU has no device records: no device metric is written
    assert "device_idle.fit" not in out["metrics"]
    assert 0 < out["metrics"]["backward_share.fit"]["value"] < 1


def _run_main(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "golden.final", "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def test_no_card_fails_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = _run_main(ROOT, env)
    assert r.returncode != 0
    assert "{" not in r.stdout
    assert "no CUDA device" in r.stderr


_KEPT = """
import ctypes, ctypes.util
from benchmark import run

class Info(ctypes.Structure):
    _fields_ = [(n, ctypes.c_size_t) for n in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks",
        "fsmblks", "uordblks", "fordblks", "keepcost")]

libc = ctypes.CDLL(ctypes.util.find_library("c"))
libc.malloc.restype = ctypes.c_void_p
libc.free.argtypes = [ctypes.c_void_p]
libc.mallinfo2.restype = Info

def kept(nbytes):
    libc.free(libc.malloc(nbytes))
    return libc.mallinfo2().fordblks >= nbytes

before = kept(64 << 20)
print(before, run.keep_freed_memory(), kept(64 << 20))
"""


def test_malloc_keeps_freed_memory():
    """In a run's process a freed 64 MB block stays in the heap, for the
    next request's arrays; by default glibc hands it back at once."""
    r = subprocess.run([sys.executable, "-c", _KEPT], cwd=ROOT,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "True", "True"]


def test_benchmark_alone_fails(tmp_path):
    """A checkout with only BENCHMARK.json and the benchmark's files has no
    program to measure."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = _run_main(tmp_path)
    assert r.returncode != 0
    assert "{" not in r.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload):
    """Each cell, briefly, on the card: correct, with its metrics."""
    bench = manifest.load(workload, 20261018)
    out = run.run_cell(bench, card, 1.0, False)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert {m["name"] for m in bench.end_to_end} == set(out["metrics"])
