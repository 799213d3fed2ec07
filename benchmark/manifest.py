"""A cell of ``BENCHMARK.json``, resolved by name into the files that
define it.

A cell names a configuration and a traffic mix.  The configuration's
``file`` (under ``benchmark/configs/``) holds its scene, size and check
sizes; the mix is ``benchmark/traffic/<traffic>.json``; the limits of its
check are ``benchmark/limits/<cell>.json``; each metric is read by
``benchmark/metrics/<metric>.py``, or, where that file is absent, by the
reader of the name's first part (``device_idle.py`` serves
``device_idle.final`` and ``device_idle.fit``).

Two more names resolve at load, before any set-up:

- The configuration's ``"reference"`` names ``benchmark/reference/
  <reference>.py`` (``linear`` where the key is absent), the plain
  reference that reads the scene and judges the cell.  A missing module
  fails here, and so does a scene that its ``parse`` refuses.  A
  reference module provides

  - ``parse(text)``: the reference's scene; raises on anything it
    cannot judge;
  - ``leaves(scene, device, dtype)``: the scene's numbers as tensors;
  - ``pixel_means(scene, leaves, pixels, spp, seed, width, height,
    lanes_per_block)``: mean radiance (P, 3), float64, of flat pixel
    indices over samples 0..spp-1, in blocks of lanes;
  - ``request_rays(scene, width, height, spp)``: the closest-hit rounds
    that one request counts toward ``rays_per_s``;
  - ``spec(scene)``: what ``yardstick.counts`` reads of the scene;
  - ``n_objects(scene)``: its objects (the large instances above
    ``yardstick.work.LARGE_ABOVE``);
  - ``work(scene, leaves, lanes, seed, width, height, large)``: per lane
    of (pixel x, pixel y, sample), what the roofline readers count.

- The mix's ``"kind"`` names ``render`` or ``fit`` of ``drive.KINDS``,
  else ``benchmark/kinds/<kind>.py``, whose ``Cell(bench, device,
  spans)`` has the methods ``run.run_cell`` calls: ``setup``, ``sync``,
  ``request(seed)``, ``next_seed``, ``free``, ``check(control=None)``
  and the attribute ``window`` (a ``drive.Window``).  A missing kind
  fails here.  A ``fit`` mix judges its steps by ``reference/fit.py``,
  which reads ``linear``'s scenes alone, so a ``fit`` mix over a
  configuration that names another reference fails here too.

So a configuration, mix, reference, kind or metric of a new shape is new
files and entries: nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
import types

from benchmark import scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_REFERENCE = "linear"
_MODULE = re.compile(r"^[A-Za-z_][A-Za-z0-9_]*$")


def _json(path: str):
    with open(path) as f:
        return json.load(f)


def _module(path: str, name: str) -> types.ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named_file(root: str, folder: str, name, owner: str) -> str:
    """``benchmark/<folder>/<name>.py`` under ``root``, named by
    ``owner``; an error that names ``owner`` where it is absent."""
    rel = f"benchmark/{folder}/{name}.py"
    path = os.path.join(root, rel)
    if not (isinstance(name, str) and _MODULE.match(name)
            and os.path.isfile(path)):
        raise FileNotFoundError(f"{owner} names {name!r}, and there is no "
                                f"{rel}")
    return path


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
    reference: types.ModuleType    # the configuration's reference
    ref: object                    # its scene, as ``reference.parse`` gave
    kind: type                     # the mix's cell class

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


def _reference(config: dict, root: str, owner: str) -> types.ModuleType:
    """The reference module that ``config`` (the file ``owner``) names."""
    name = config.get("reference", DEFAULT_REFERENCE)
    return _module(_named_file(root, "reference", name, owner),
                   f"benchmark.reference.{name}")


def _kind(traffic: dict, root: str, owner: str) -> type:
    """The cell class of a mix's ``kind``."""
    from benchmark import drive

    name = traffic["kind"]
    if name in drive.KINDS:
        return drive.KINDS[name]
    return _module(_named_file(root, "kinds", name, owner),
                   f"benchmark.kinds.{name}").Cell


def load(workload: str, seed: int, root: str = ROOT,
         manifest: dict | None = None) -> Bench:
    """The cell ``workload`` of the manifest at ``root`` (or ``manifest``),
    resolved into its files, its reference and its kind."""
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
    mix = f"benchmark/traffic/{cell['traffic']}.json"
    traffic = _json(os.path.join(root, mix))
    ref_mod = _reference(config, root, entry["file"])
    cell_class = _kind(traffic, root, mix)
    if (traffic["kind"] == "fit"
            and config.get("reference", DEFAULT_REFERENCE)
            != DEFAULT_REFERENCE):
        raise ValueError(f"{workload}: a fit mix judges its steps by "
                         f"reference/fit.py, which reads "
                         f"{DEFAULT_REFERENCE!r} scenes only; "
                         f"{entry['file']} names {config['reference']!r}")
    text = scenes.scene_text(config, os.path.dirname(cfg_path))
    try:
        ref = ref_mod.parse(text)
    except ValueError as e:
        raise ValueError(f"{entry['file']}: its reference "
                         f"{ref_mod.__name__} cannot judge the scene: {e}"
                         ) from e
    limits = _json(os.path.join(here, "limits", f"{workload}.json"))
    e2e = [m for m in man["end_to_end"] if applies(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if applies(m, workload, names)]
    return Bench(name=workload, root=root, cell=cell, config=config,
                 traffic=traffic, limits=limits, end_to_end=e2e,
                 per_layer=per_layer, seed=seed, scene_text=text,
                 reference=ref_mod, ref=ref, kind=cell_class)


def reader(name: str, root: str = ROOT):
    """The ``read(run)`` function of metric ``name``: its own file, else
    the file of the name's first part."""
    here = os.path.join(root, "benchmark", "metrics")
    path = os.path.join(here, f"{name}.py")
    if not os.path.exists(path):
        path = os.path.join(here, f"{name.split('.')[0]}.py")
    return _module(path, "benchmark.metrics." + name.replace(".", "_")).read
