"""The port's megakernel module: radiance_lanes against the JAX package's
megakernel (interpret mode on the CPU), the slice gate, the dispatch
rules, and an import that pulls in neither JAX nor a kernel build."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render import megakernel as jax_mk
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.ops.intersect import object_table
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene import schema
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import REPO_ROOT, repo_path

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))

# Monte-Carlo paths fork after a near-tie when two roundings differ by an
# ulp, so a few lanes may disagree by a lot (the JAX package's kernel and
# its jnp path miss the per-lane rule on 0.3% of lanes); the means must
# still agree
LANE_RTOL = 1e-4
MIN_LANES_OK = 0.99
MEAN_RTOL = 1e-3


def _lanes(n, seed=3):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, 512, n), rs.randint(0, 512, n),
            rs.randint(0, 256, n), np.zeros(n, np.int64))


def assert_radiance_close(got: np.ndarray, want: np.ndarray):
    """(3, N) radiance arrays within the tolerance above."""
    assert np.isfinite(got).all()
    ok = (np.abs(got - want) <= LANE_RTOL * np.maximum(1.0, np.abs(want)))
    assert ok.all(axis=0).mean() >= MIN_LANES_OK, ok.all(axis=0).mean()
    np.testing.assert_allclose(got.mean(axis=1), want.mean(axis=1),
                               rtol=MEAN_RTOL)


def test_radiance_lanes_matches_jax_kernel(monkeypatch):
    monkeypatch.setenv("RAYTRACE_TPU_MEGAKERNEL_INTERPRET", "1")
    js = jax_load(CORNELL, dtype=jnp.float32)
    ts = torch_load(CORNELL, device="cpu")
    assert jax_mk.usable(js.data, js.spec) and megakernel.usable(ts.data,
                                                                 ts.spec)
    lanes = _lanes(2048)
    want = jax_mk.radiance_lanes(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes),
        seed=3)
    got = megakernel.radiance_lanes(
        ts.data, ts.spec, *(torch.from_numpy(a.astype(np.int64))
                            for a in lanes), 3)
    assert_radiance_close(torch.stack(list(got)).double().numpy(),
                          np.stack([np.asarray(w, np.float64) for w in want]))
    assert float(got.x.max()) > 0.0


def _variant(**spec_changes):
    ts = torch_load(CORNELL, device="cpu")
    return ts.data, dataclasses.replace(ts.spec, **spec_changes)


def _out_of_slice():
    f64 = torch_load(CORNELL, device="cpu", dtype=torch.float64)
    showcase = torch_load(SHOWCASE, device="cpu")
    n = 65
    return {
        "f64": (f64.data, f64.spec, 12),
        "objects": (*_variant(shape_type=(schema.SHAPE_SPHERE,) * n,
                              mat_type=(schema.MAT_INDIRECT_PHONG,) * n), 10),
        "fan-out": (showcase.data, showcase.spec, 9),
        "skybox": (*_variant(bg_type=schema.BG_SKYBOX), 11),
        "depth of field": (*_variant(cam_type=schema.CAM_DEPTH_OF_FIELD), 8),
        "lights": (*_variant(light_type=(schema.LIGHT_POINT,)), 8),
        "mirror": (*_variant(has_reflect=True, n_indirect=0), 8),
        "fresnel": (*_variant(mat_type=(schema.MAT_FRESNEL,) * 7), 9),
        "transparent": (*_variant(mat_type=(schema.MAT_TRANSPARENT,) * 7), 9),
    }


@pytest.mark.parametrize("feature", list(_out_of_slice()))
def test_usable_refuses_out_of_slice(feature):
    data, spec, item = _out_of_slice()[feature]
    assert not megakernel.usable(data, spec)
    lanes = [torch.zeros(4, dtype=torch.int64)] * 4
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}\\b"):
        megakernel.radiance_lanes(data, spec, *lanes, 0)


def test_gradients_not_ported():
    ts = torch_load(CORNELL, device="cpu")
    ts.data.prim_p.requires_grad_(True)
    lanes = [torch.zeros(4, dtype=torch.int64)] * 4
    with pytest.raises(NotImplementedError, match="ROADMAP item 7"):
        megakernel.radiance_lanes(ts.data, ts.spec, *lanes, 0)


def test_cpu_dispatch_is_the_plain_version():
    ts = torch_load(CORNELL, device="cpu")
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in _lanes(256, 5)]
    before = megakernel.LAUNCHES
    got = megakernel.radiance_lanes(ts.data, ts.spec, *lanes, 5)
    want = megakernel.radiance_lanes_reference(ts.data, ts.spec, *lanes, 5)
    assert megakernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        megakernel.radiance_lanes(ts.data, ts.spec, lanes[0][:3], *lanes[1:],
                                  5)


def test_pack_scene_layout():
    """The buffer the CUDA kernel reads: its header and object rows
    (csrc/megakernel_linear.cu, HDR = 19 and ROW = 16)."""
    ts = torch_load(CORNELL, device="cpu")
    buf = megakernel.pack_scene(ts.data, ts.spec)
    assert buf.dtype == torch.float32 and buf.shape == (19 + 16 * 7,)
    assert torch.equal(buf[0:3], ts.data.cam_position)
    assert torch.equal(buf[3:12], ts.data.cam_matrix.reshape(9))
    assert torch.equal(buf[12:15], ts.data.bg_color)
    np.testing.assert_array_equal(
        buf[15:19].numpy(),
        np.float32([256.0, 256.0, 1 / 256.0, schema.MIN_SIGNIFICANCE]))
    rows = buf[19:].reshape(7, 16)
    tab = object_table(ts.data, ts.spec)
    assert torch.equal(rows[:, 0:6], tab[:, 0:6])      # geometry
    assert torch.equal(rows[:, 6:9], tab[:, 6:9])      # diffuse
    assert torch.equal(rows[:, 9:12], tab[:, 12:15])   # ambient
    assert torch.equal(rows[:, 12], ts.data.mat_samples)
    assert rows[:, 13].tolist() == [0.0] * 5 + [1.0] * 2  # sphere flag
    assert rows[:, 14].tolist() == [1.0] * 7              # IndirectPhong


def test_import_pulls_in_no_jax_and_builds_nothing():
    build = _build.BUILD_DIR
    before = sorted(os.listdir(build)) if os.path.isdir(build) else None
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        "import raytrace_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'raytrace_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from raytrace_tpu_torch.ops import _build\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'raytrace_tpu')]\n"
        "print(len(mods), bad, _build.loaded())\n")
    r = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_mods, rest = r.stdout.split(" ", 1)
    assert int(n_mods) >= 20
    assert rest.strip() == "[] []"
    after = sorted(os.listdir(build)) if os.path.isdir(build) else None
    assert after == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    ts = torch_load(CORNELL, device=cuda_device)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device)
             for a in _lanes(8192, 7)]
    before = megakernel.LAUNCHES
    got = megakernel.radiance_lanes(ts.data, ts.spec, *lanes, 7)
    want = megakernel.radiance_lanes_reference(ts.data, ts.spec, *lanes, 7)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES == before + 1
    assert_radiance_close(torch.stack(list(got)).double().cpu().numpy(),
                          torch.stack(list(want)).double().cpu().numpy())


@pytest.mark.cuda
def test_card_raises_out_of_slice(cuda_device):
    data, spec, _ = _out_of_slice()["lights"]
    lanes = [torch.zeros(4, dtype=torch.int64, device=cuda_device)] * 4
    with pytest.raises(NotImplementedError, match="ROADMAP item 8"):
        megakernel.radiance_lanes(data.to(cuda_device), spec, *lanes, 0)
