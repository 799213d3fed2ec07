"""The tree reference (``reference/tree.py``) agrees with the port's plain
path on mixed sphere fields, small (K3's small regime in the port) and
large (its table fold), refuses what it does not implement, imports
nothing of the port, and judges ``field1k_mix.final`` through
``manifest.load`` from a copy of the benchmark."""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

from benchmark import manifest, scenes
from benchmark.reference import tree
from benchmark.tests.test_harness_reference import _loaded_after
from raytrace_tpu_torch import bench as port_bench
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene

ROOT = manifest.ROOT
SEED = 2 ** 31 + 9
CELL = "field1k_mix.final"


def _example(name: str) -> str:
    with open(os.path.join(ROOT, "examples", name)) as f:
        return f.read()


def _port(text, w, h):
    sc = build_scene(dsl.parse(text), device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=w, height=h))


@pytest.mark.parametrize("n", [40, 100])
@pytest.mark.parametrize("gen_seed", [1, 2, 3])
def test_lanes_and_image_agree(n, gen_seed):
    """Each lane's radiance is the port's plain path's to the bit: the same
    float32 operations on each lane, its contributions added in the same
    order.  The images differ by rounding alone: the port's is a float32
    mean of each launch's samples summed in float64, the reference's a
    float64 mean, so ``rtol`` 1e-6 holds what float32's 6e-8 a step
    leaves, and ``atol`` 1e-9 the pixels near 0."""
    text = scenes.sphere_field(n, mix_materials=True, seed=gen_seed)
    sc = _port(text, 12, 10)
    ref = tree.parse(text)
    lv = tree.leaves(ref, "cpu", torch.float32)
    g = torch.Generator().manual_seed(gen_seed)
    px, py, aa = (torch.randint(0, k, (256,), generator=g)
                  for k in (12, 10, 4))
    want = torch.stack(tuple(megakernel.radiance_lanes(
        sc.data, sc.spec, px, py, aa, torch.zeros_like(px), SEED)), 1)
    got = tree.walk(ref, lv, px, py, aa, SEED, 12, 10)
    assert torch.equal(got, want)
    img = render_image(sc, seed=SEED, spp=2)
    means = tree.pixel_means(ref, lv, torch.arange(120), 2, SEED, 12, 10,
                             1 << 6).numpy()
    np.testing.assert_allclose(img.reshape(-1, 3), means, rtol=1e-6,
                               atol=1e-9)


def test_walk_fans_out():
    """The mixed field takes K3 (three slots, two children a node): a
    6-level binary tree of 63 nodes, 63 rounds a primary sample, as the
    port's ``bench.ray_counts`` counts a fan-out scene."""
    text = scenes.sphere_field(1000, width=1024, height=1024, antialias=16)
    ref = tree.parse(text)
    spec = _port(text, 1024, 1024).spec
    assert megakernel.kernel_for(spec) == megakernel.KERNEL_TREE
    assert (ref.children_per_ray, ref.fan_out) == (3, 2) == (
        spec.children_per_ray, spec.max_live_children)
    assert tree.nodes(ref) == 63
    rays = port_bench.ray_counts(spec, 1024 * 1024, 16)
    assert tree.request_rays(ref, 1024, 1024, 16) == \
        rays["primary"] * rays["rounds"] == 1_056_964_608
    assert np.bincount(ref.kind).tolist() == [250, 256, 250, 250]


def _no_lights(text: str) -> str:
    return re.sub(r"lights: \[.*?\n    \]", "lights: [ ]", text, flags=re.S)


LIT = scenes.sphere_field(40).replace(
    "lights: [ ]", "lights: [ { model: PointLight { location: (0, 5, 0) } "
    "color: rgb(1, 1, 1) } ]")
REFUSED = {
    "showcase": (_example("materials_showcase.txt"), "lights"),
    # a skybox's faces are file names, which the reader cannot read
    "skybox": (_example("skybox_ball.txt"), "sky_px.bmp"),
    "light": (LIT, "lights"),
    "dof": (_no_lights(_example("materials_showcase.txt")), "camera"),
    "glossy_indirect": (scenes.sphere_field(40).replace(
        "specular: rgb(0, 0, 0)\n            exponent: 1.0 ambient: rgb(6",
        "specular: rgb(0.5, 0, 0)\n            exponent: 1.0 ambient: rgb(6"),
        "specular"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_parse_refuses(case):
    text, word = REFUSED[case]
    with pytest.raises(ValueError, match=word):
        tree.parse(text)


@pytest.fixture
def copied(tmp_path):
    """A copy of the benchmark in ``tmp_path``: its root."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


@pytest.mark.parametrize("case", ["showcase", "skybox", "light"])
def test_config_naming_a_refused_scene_fails_at_load(copied, case):
    text, word = REFUSED[case]
    cfg = copied / "benchmark" / "configs" / "field1k_mix.json"
    (copied / "benchmark" / "configs" / "refused.txt").write_text(text)
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()),
                                   scene={"scene_file": "refused.txt"})))
    with pytest.raises(ValueError) as e:
        manifest.load(CELL, SEED, root=str(copied))
    assert "benchmark/configs/field1k_mix.json" in str(e.value)
    assert word in str(e.value)


def test_tree_imports_nothing_of_the_port():
    top = _loaded_after("import benchmark.reference.tree, "
                        "benchmark.reference.tree_scene")
    assert not {"raytrace_tpu", "raytrace_tpu_torch", "jax"} & set(top)


def test_cell_dispatches_from_a_copy(copied):
    """``field1k_mix.final`` resolves, from a copied tree, to that tree's
    ``reference/tree.py``, whose answers the harness takes: the
    generator's mixed field, its rays, its spec and its objects."""
    b = manifest.load(CELL, SEED, root=str(copied))
    assert b.reference.__file__ == str(copied / "benchmark" / "reference"
                                       / "tree.py")
    assert b.config["reference"] == "tree"
    assert b.scene_text == scenes.sphere_field(
        1000, width=1024, height=1024, antialias=16, seed=0,
        mix_materials=True)
    assert b.reference.n_objects(b.ref) == b.config["objects"] == 1006
    assert b.reference.request_rays(b.ref, 1024, 1024, 16) == 1_056_964_608
    spec = b.reference.spec(b.ref)
    assert (spec.max_depth, spec.cam_samples, spec.n_lights) == (4, 1, 0)
    assert set(b.limits) == {"pixel_gap", "bytes_off"}
    assert {m["name"] for m in b.per_layer} >= {"k3_large_roofline"}
    assert {m["name"] for m in b.end_to_end} == {"rays_per_s",
                                                 "image_s_p95", "setup_s"}
