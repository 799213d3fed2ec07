"""The reference agrees with the port's plain path at a CPU test's size,
renders and gradients (the test imports both; the reference imports
nothing of the port), and imports nothing it must not."""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import manifest, run, scenes
from benchmark.reference import encode
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene
from raytrace_tpu_torch import color, optim
from raytrace_tpu_torch.io import bmp
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene

GOLDEN = open(scenes.__file__.replace("scenes.py",
                                      "configs/golden.txt")).read()
FIELD = scenes.sphere_field(1000, mix_materials=False)


def _port(text, w, h):
    sc = build_scene(dsl.parse(text), device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=w, height=h))


@pytest.mark.parametrize("text, spp", [(GOLDEN, 8), (FIELD, 2)])
def test_render_agrees(text, spp):
    img = render_image(_port(text, 12, 10), seed=2 ** 31 + 9, spp=spp)
    ref = ref_scene.parse(text)
    means = ref_render.pixel_means(
        ref, ref_render.leaves(ref, "cpu", torch.float32), torch.arange(120),
        spp, 2 ** 31 + 9, 12, 10, 1 << 14).numpy()
    np.testing.assert_allclose(img.reshape(-1, 3), means, rtol=1e-5,
                               atol=1e-6)


def test_gradients_agree():
    sc = _port(GOLDEN, 16, 16)
    pix = torch.arange(256)
    px, py = pix % 16, pix // 16
    target = torch.rand(256, 3, generator=torch.Generator().manual_seed(1))
    loss, grads = optim.loss_and_grad(sc.data, sc.spec, px, py,
                                      torch.arange(1), 41, target)
    ref = ref_scene.parse(GOLDEN)
    lv = ref_render.leaves(ref, "cpu", torch.float32, requires_grad=True)
    rad = ref_render.chain(ref, lv, px, py, torch.zeros_like(px), 41, 16, 16)
    mine = torch.sum((rad - target) ** 2)
    mine.backward()
    assert float(mine.detach()) == pytest.approx(float(loss), rel=1e-6)
    for name, leaf in lv.items():
        want = getattr(grads, name)
        got = leaf.grad if leaf.grad is not None else torch.zeros_like(want)
        scale = max(float(want.abs().max()), 1.0)
        assert float((got - want).abs().max()) <= 1e-4 * scale, name


def test_encode_agrees():
    img = np.random.RandomState(0).rand(9, 7, 3) * 1.4 - 0.2
    img[0, 0, 0] = np.nan
    c = np.clip(img, 0.0, None).astype(np.float32)
    srgb = color.to_srgb(torch.from_numpy(c)).numpy()
    assert encode.bmp_bytes(img) == bmp.header(7, 9) + bmp.encode_rows(
        srgb).tobytes()


def _loaded_after(code: str) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({m.split('.')[0] "
        "for m in sys.modules})))")], cwd=manifest.ROOT, capture_output=True,
        text=True, timeout=300, check=True, env=env)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_imports_nothing_of_the_port():
    top = _loaded_after("import benchmark.reference.render, "
                        "benchmark.reference.fit, benchmark.reference.encode,"
                        " benchmark.yardstick.counts, "
                        "benchmark.yardstick.work")
    assert not {"raytrace_tpu", "raytrace_tpu_torch", "jax"} & set(top)


def test_a_run_loads_no_jax():
    """Every module a CPU run loads, compared by its whole top-level name:
    the port's ``raytrace_tpu_torch`` passes, ``raytrace_tpu`` would not."""
    top = _loaded_after(
        "import torch\n"
        "from benchmark import manifest, run\n"
        "from benchmark.tests.conftest import load, small\n"
        "b = small(load('golden.fit', 4))\n"
        "run.run_cell(b, torch.device('cpu'), 0.1, True)\n"
        "b = small(manifest.load('field1k.final', 4))\n"
        "run.run_cell(b, torch.device('cpu'), 0.1, True)\n"
        "assert run.forbidden_modules() == []")
    assert "raytrace_tpu_torch" in top
    assert not set(run.FORBIDDEN) & set(top)


def test_forbidden_names_are_whole():
    ok = ["raytrace_tpu_torch", "raytrace_tpu_torch.ops", "jaxtyping",
          "flaxen", "torch"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["raytrace_tpu.scene", "jax.numpy",
                                       "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "raytrace_tpu"]
