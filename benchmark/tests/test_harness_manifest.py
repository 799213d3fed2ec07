"""Each cell of BENCHMARK.json resolves into its files, and the manifest
keeps to the contract's shapes; a new configuration and mix are files and
entries only."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest
import torch

from benchmark import manifest, run
from benchmark.tests.conftest import OUT, OUT_CELLS, load

ROOT = manifest.ROOT
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS + OUT_CELLS)
def test_cell_resolves(workload):
    b = load(workload, 1)
    assert b.traffic["kind"] in ("render", "fit")
    names = {m["name"] for m in b.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert b.per_layer
    for m in b.end_to_end + b.per_layer:
        assert callable(manifest.reader(m["name"]))
    assert set(b.limits) >= ({"pixel_gap", "bytes_off"}
                             if b.traffic["kind"] == "render"
                             else {"loss_gap", "grad_gap", "change_gap"})


def test_manifest_shapes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(MAN["paths"][0] + "/")
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    moves = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in MAN["per_layer"]:
        assert m["moves"] in moves and set(m["workloads"]) <= set(CELLS)
    # the entries of the cells out of the manifest keep its shapes
    assert not set(OUT_CELLS) & set(CELLS)
    for m in [m for out in OUT for m in out["end_to_end"] + out["per_layer"]]:
        assert NAME.match(m["name"]) and m["name"] not in moves
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in MAN["end_to_end"] + MAN["per_layer"] + MAN["workloads"]:
        assert NAME.match(m["name"])


def test_added_config_and_mix_run(tmp_path):
    """A copy of the benchmark gains a configuration (a sphere field of 40
    spheres) and a mix (a 2-sample preview) as new files and entries; the
    harness finds and runs them."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bdir = tmp_path / "benchmark"
    cfg = {"name": "field40", "source": "a test's field",
           "scene": {"generator": "sphere_field",
                     "args": {"n_spheres": 40, "width": 12, "height": 12,
                              "antialias": 2, "mix_materials": False}},
           "width": 12, "height": 12, "samples": 2, "max_depth": 4,
           "reduced": [], "check_lanes": 288, "check_block": 4096,
           "work_lanes": 64}
    (bdir / "configs" / "field40.json").write_text(json.dumps(cfg))
    mix = {"kind": "render", "samples": 2, "check_images": 1,
           "trace_requests": 1}
    (bdir / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (bdir / "limits" / "field40.tiny.json").write_text(
        json.dumps({"pixel_gap": 1e-3, "bytes_off": 0}))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "field40", "source": "a test's field",
                           "file": "benchmark/configs/field40.json",
                           "reduced": [], "why": "a test"})
    man["workloads"].append({"name": "field40.tiny", "config": "field40",
                             "traffic": "tiny", "chips": 1, "why": "a test"})
    for m in man["end_to_end"]:
        if m["name"] == "rays_per_s":
            m["workloads"].append("field40.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    b = manifest.load("field40.tiny", 3, root=str(tmp_path))
    out = run.run_cell(b, torch.device("cpu"), 0.1, False)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"rays_per_s", "setup_s"}
