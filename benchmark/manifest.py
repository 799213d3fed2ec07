"""A cell of ``BENCHMARK.json``, resolved by name into the files that
define it.

A cell names a configuration and a traffic mix.  The configuration's
``file`` (under ``benchmark/configs/``) holds its scene, size and check
sizes; the mix is ``benchmark/traffic/<traffic>.json``; the limits of its
check are ``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<metric>.py``, or, where that file is absent, by the
reader of the name's first part (``device_idle.py`` serves
``device_idle.final`` and ``device_idle.fit``).  A new configuration, mix
or metric is new files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

from benchmark import scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Bench:
    """Everything one run of one cell reads."""

    name: str
    root: str
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    seed: int
    scene_text: str

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])


def applies(metric: dict, cell: str, moves_of_cell=None) -> bool:
    """Whether a metric is reported in ``cell``: by its ``workloads`` list,
    else every cell (an end-to-end metric) or every cell that reports the
    end-to-end metric it moves (a per-layer one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return moves_of_cell is None or metric["moves"] in moves_of_cell


def load(workload: str, seed: int, root: str = ROOT,
         manifest: dict | None = None) -> Bench:
    """The cell ``workload`` of the manifest at ``root`` (or ``manifest``),
    resolved into its files."""
    man = manifest if manifest is not None else _json(
        os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    cfg_path = os.path.join(root, entry["file"])
    config = _json(cfg_path)
    here = os.path.join(root, "benchmark")
    traffic = _json(os.path.join(here, "traffic", f"{cell['traffic']}.json"))
    limits = _json(os.path.join(here, "limits", f"{workload}.json"))
    e2e = [m for m in man["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if applies(m, workload, names)]
    return Bench(name=workload, root=root, cell=cell, config=config, traffic=traffic,
                 limits=limits, end_to_end=e2e, per_layer=per_layer,
                 seed=seed,
                 scene_text=scenes.scene_text(config,
                                              os.path.dirname(cfg_path)))


def reader(name: str, root: str = ROOT):
    """The ``read(run)`` function of metric ``name``: its own file, else
    the file of the name's first part."""
    here = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(here, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(here, f"{name.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
