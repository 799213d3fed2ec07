"""A configuration's reference and a mix's kind resolve by name at load:
today's cells get the ``linear`` reference, whose functions are the plain
renderer's and the yardstick's to the bit; a reference or kind of a new
shape is a new file that the harness calls, in a copy of the benchmark
that gains nothing but files and entries; a name with no file, and a
scene its reference refuses, fail in ``manifest.load``."""

from __future__ import annotations

import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

from benchmark import manifest, run
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene
from benchmark.tests.conftest import small
from benchmark.trace import Spans
from benchmark.yardstick import counts, work

ROOT = manifest.ROOT
CPU = torch.device("cpu")
SEED = 2 ** 31 + 77

STUB = '''"""A test's reference: the linear scene, known answers."""
import torch
from benchmark.reference import linear

PARSED = []
RAYS = 1234567
WORK = {"visits": 4.25, "hits": 3.5, "last_hits": 0.75, "misses": 0.0,
        "chunks": 11.7}


def parse(text):
    PARSED.append(len(text))
    return linear.parse(text)


leaves = linear.leaves
spec = linear.spec


def pixel_means(scene, leaves, pixels, spp, seed, width, height, block):
    return torch.full((pixels.shape[0], 3), 0.5, dtype=torch.float64)


def request_rays(scene, width, height, spp):
    return RAYS


def n_objects(scene):
    return 65


def work(scene, leaves, lanes, seed, width, height, large):
    return dict(WORK, large=large)
'''

TALLY = '''"""A test's kind: requests that count, a check of the count."""
import time
from benchmark import drive


class Cell(drive.Cell):
    def setup(self):
        self.done = 0

    def request(self, seed, keep=True):
        t0 = time.perf_counter()
        self.done += 1
        if keep:
            self.window.latencies.append(time.perf_counter() - t0)

    def check(self, control=None):
        return {"missed": float(len(self.window.latencies) - self.done)}
'''


def _golden_small(**kw) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "golden.json")) as f:
        cfg = json.load(f)
    return dict(cfg, width=12, height=12, samples=2, check_lanes=288,
                check_block=4096, work_lanes=64, **kw)


@pytest.fixture
def copy(tmp_path):
    """``copy(cell, config=None, mix=None, limits=None, files={})``: a copy
    of the benchmark in ``tmp_path`` that gains the cell ``<config>.<mix>``
    as new files (``files``: paths under ``benchmark/`` and their text)
    and entries; returns the cell's loader."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bdir = tmp_path / "benchmark"

    def add(cell, config=None, mix=None, limits=None, files=None):
        cfg_name, mix_name = cell.split(".")
        man = json.loads((tmp_path / "BENCHMARK.json").read_text())
        for rel, text in (files or {}).items():
            (bdir / rel).parent.mkdir(parents=True, exist_ok=True)
            (bdir / rel).write_text(text)
        if config is not None:
            (bdir / "configs" / f"{cfg_name}.json").write_text(
                json.dumps(dict(config, name=cfg_name)))
            man["configs"].append({
                "name": cfg_name, "source": "a test's configuration",
                "file": f"benchmark/configs/{cfg_name}.json", "reduced": [],
                "why": "a test"})
        if mix is not None:
            (bdir / "traffic" / f"{mix_name}.json").write_text(
                json.dumps(mix))
        (bdir / "limits" / f"{cell}.json").write_text(
            json.dumps(limits or {}))
        man["workloads"].append({"name": cell, "config": cfg_name,
                                 "traffic": mix_name, "chips": 1,
                                 "why": "a test"})
        (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
        return lambda seed=SEED: manifest.load(cell, seed,
                                               root=str(tmp_path))
    return add


@pytest.mark.parametrize("workload", ["golden.final", "field1k.final"])
def test_default_reference_is_linear(workload):
    """A configuration without the key gets ``reference/linear.py``, whose
    functions give the direct calls' answers to the bit, at 16x16x4."""
    b = small(manifest.load(workload, SEED), samples=4)
    assert "reference" not in b.config
    assert b.reference.__file__ == os.path.join(ROOT, "benchmark",
                                                "reference", "linear.py")
    ref = ref_scene.parse(b.scene_text)
    assert np.array_equal(b.ref.shape, ref.shape)
    pix = torch.arange(0, 256, 3)
    lv = ref_render.leaves(ref, CPU, torch.float32)
    want = ref_render.pixel_means(ref, lv, pix, 4, SEED, 16, 16, 1 << 10)
    got = b.reference.pixel_means(
        b.ref, b.reference.leaves(b.ref, CPU, torch.float32), pix, 4, SEED,
        16, 16, 1 << 10)
    assert got.dtype == torch.float64 and torch.equal(got, want)
    rays = counts.ray_counts(work.ref_spec(ref), 256, 4)
    assert b.reference.request_rays(b.ref, 16, 16, 4) == \
        rays["primary"] * rays["rounds"]
    assert b.reference.spec(b.ref) == work.ref_spec(ref)
    assert b.reference.n_objects(b.ref) == ref.n_objects
    g = torch.Generator().manual_seed(5)
    p = torch.randint(0, 256, (64,), generator=g)
    lanes = (p % 16, p // 16, torch.randint(0, 4, (64,), generator=g))
    large = ref.n_objects > work.LARGE_ABOVE
    assert large == (workload == "field1k.final")
    assert b.reference.work(b.ref, lv, lanes, 9, 16, 16, large) == \
        work.path_work(ref, lv, lanes, 9, 16, 16, large)
    # the harness's own calls: a request's rays and Run's readings
    cell = b.kind(b, CPU, Spans())
    cell.setup()
    cell.request(cell.next_seed())
    assert cell.window.rays == rays["primary"] * rays["rounds"]
    r = run.Run(b, cell, 0.0)
    assert r.spec == work.ref_spec(ref) and r.large == large
    rng = np.random.default_rng([SEED, 5])
    px = rng.integers(0, 256, 256)
    lanes = tuple(torch.as_tensor(a) for a in (px % 16, px // 16,
                                               rng.integers(0, 4, 256)))
    assert r.work() == work.path_work(ref, lv, lanes,
                                      int(rng.integers(0, 2 ** 31 - 1)),
                                      16, 16, large)


def test_named_reference_is_what_the_harness_calls(copy):
    """A configuration that names ``stub`` (a new file) is judged, counted
    and read by it: the check's pixels, a request's rays, Run's spec,
    size and work."""
    load = copy("stubbed.final", config=_golden_small(reference="stub"),
                files={"reference/stub.py": STUB})
    b = load()
    assert b.reference.PARSED == [len(b.scene_text)]
    cell = b.kind(b, CPU, Spans())
    cell.setup()
    for _ in range(3):
        cell.request(cell.next_seed())
    assert cell.window.rays == 3 * b.reference.RAYS
    r = run.Run(b, cell, 0.0)
    assert r.large is True and r.work() == dict(b.reference.WORK, large=True)
    assert r.spec == b.reference.spec(b.ref)
    imgs = [img for _, img, _ in cell.kept]
    assert len(imgs) == b.traffic["check_images"]
    cell.free()
    out = cell.check()
    # every pixel is drawn (check_lanes = 12 * 12 * 2): the gap to 0.5
    want = (sum(float(np.abs(i.reshape(-1, 3) - 0.5).sum()) for i in imgs)
            / (0.5 * 3 * 144 * len(imgs)))
    assert out == {"pixel_gap": pytest.approx(want, rel=1e-12),
                   "bytes_off": 0}
    assert cell.check(control=torch.bfloat16) == {"pixel_gap": 0.0}


SHOWCASE = open(os.path.join(ROOT, "examples", "materials_showcase.txt")
                ).read()


@pytest.mark.parametrize("case", ["absent", "path", "showcase", "fit",
                                  "kind"])
def test_refused_at_load(copy, monkeypatch, case):
    """A reference or kind with no file, a scene the reference refuses
    (the showcase's lights under ``linear``), and a fit mix over another
    reference: each fails in ``manifest.load``, which precedes set-up."""
    def no_setup(self):
        raise AssertionError("set-up ran")
    from benchmark import drive
    monkeypatch.setattr(drive.RenderCell, "setup", no_setup)
    monkeypatch.setattr(drive.FitCell, "setup", no_setup)
    stub = {"reference/stub.py": STUB}
    if case == "absent":
        load = copy("absent.final", config=_golden_small(reference="absent"))
        err, words = FileNotFoundError, ["benchmark/configs/absent.json",
                                         "benchmark/reference/absent.py"]
    elif case == "path":
        load = copy("up.final", config=_golden_small(reference="../scenes"))
        err, words = FileNotFoundError, ["benchmark/configs/up.json"]
    elif case == "showcase":
        load = copy("showcase.final", config=_golden_small(
            scene={"scene_file": "showcase.txt"}),
            files={"configs/showcase.txt": SHOWCASE})
        err, words = ValueError, ["benchmark/configs/showcase.json",
                                  "lights"]
    elif case == "fit":
        load = copy("stubbed.fit", config=_golden_small(reference="stub"),
                    files=stub)
        err, words = ValueError, ["reference/fit.py", "'stub'"]
    else:
        load = copy("golden.absent", mix={"kind": "absent"})
        err, words = FileNotFoundError, ["benchmark/traffic/absent.json",
                                         "benchmark/kinds/absent.py"]
    with pytest.raises(err) as e:
        load()
    for w in words:
        assert w in str(e.value)


def test_kind_from_its_file(copy):
    """A mix of kind ``tally`` is run by ``benchmark/kinds/tally.py``'s
    ``Cell``, a new file."""
    load = copy("golden.tally", mix={"kind": "tally", "trace_requests": 1},
                limits={"missed": 0}, files={"kinds/tally.py": TALLY})
    b = load()
    assert b.kind.__name__ == "Cell"
    assert b.kind.__module__ == "benchmark.kinds.tally"
    out = run.run_cell(b, CPU, 0.05, False)
    assert out["correct"] is True and out["attempted"] >= 1
    assert out["checks"] == {"missed": {"value": 0.0, "limit": 0}}
    assert set(out["metrics"]) == {"setup_s"}


@pytest.mark.parametrize("name", ["drive.py", "run.py", "control.py"])
def test_callers_import_no_reference_scene(name):
    """The harness reaches a cell's scene through its resolved reference:
    these modules import neither ``reference.scene`` nor ``.render``."""
    with open(os.path.join(ROOT, "benchmark", name)) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names |= {f"{node.module}.{a.name}" for a in node.names}
    assert not {"benchmark.reference.scene", "benchmark.reference.render"
                } & names
