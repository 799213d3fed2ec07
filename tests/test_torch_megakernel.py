"""The port's megakernel module: radiance_lanes against the JAX package's
megakernel (interpret mode on the CPU) on scenes of every feature of the
slice, the slice gate, the dispatch rules, the scene buffer, and an
import that pulls in neither JAX nor a kernel build."""

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
    """Scenes the kernels do not take: float64 ones, among them a fan-out
    tree whose DFS stack exceeds 64 entries (65 indirect slots at
    max_depth 0: a stack of 65, 66 nodes per lane), which the kernels take
    in float32 (tests/test_torch_deep_tree.py)."""
    f64 = torch_load(CORNELL, device="cpu", dtype=torch.float64)
    return {
        "f64": (f64.data, f64.spec, 12),
        "deep tree": (f64.data, dataclasses.replace(
            f64.spec, n_indirect=65, max_depth=0), 12),
    }


def test_usable_takes_skybox_scenes():
    data, spec = _variant(bg_type=schema.BG_SKYBOX)
    assert megakernel.usable(data, spec)
    assert megakernel.unsupported_reason(data, spec) is None


@pytest.mark.parametrize("feature", list(_out_of_slice()))
def test_usable_refuses_out_of_slice(feature):
    """Outside the kernels' slice, and so refused on the card (the
    ``cuda``-marked test below); on CPU tensors radiance_lanes renders it
    all the same, through the plain version."""
    data, spec, item = _out_of_slice()[feature]
    assert not megakernel.usable(data, spec)
    assert f"ROADMAP item {item}" in megakernel.unsupported_reason(data, spec)
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in _lanes(64, 6)]
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(data, spec, *lanes, 6)
    want = megakernel.radiance_lanes_reference(data, spec, *lanes, 6)
    assert megakernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert g.dtype == data.dtype and torch.equal(g, w)
    assert float(got.x.max()) > 0.0


# a Phong mirror floor and a Phong sphere under a point and a directional
# light, seen through a depth-of-field camera: linear (one reflect slot)
LIT_MIRROR = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8
        ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }
  ]
  lights: [
    { model: PointLight { location: (2, 3, -1) } color: rgb(1.2,1.1,1.0) }
    { model: DirectionalLight { direction: (0, -1, -0.2) }
      color: rgb(0.3, 0.3, 0.35) }
  ]
  camera: DepthOfFieldCamera new(
    new((0,0,0), (0,0,-1), (0,1,0), 2),
    4.0, 0.05, 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 32 height: 32 antialias: 2 }
}"""
_SPHERE = """material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }"""
_SIMPLE_CAMERA = "camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 2)"
_DOF_CAMERA = """camera: DepthOfFieldCamera new(
    new((0,0,0), (0,0,-1), (0,1,0), 2),
    4.0, 0.05, 2)"""
_LIGHTS = LIT_MIRROR[LIT_MIRROR.index("lights: ["):
                     LIT_MIRROR.index("camera:")]


def in_slice_scene(feature):
    """(scene text, max_depth) of the scene that exercises ``feature``;
    "depth of field" is the lit mirror scene above, "transparent" a glass
    sphere at max_depth 2 (a 15-node tree), "fan-out" a 4-sample
    IndirectPhong sphere at max_depth 2 (85 nodes, m = 4)."""
    if feature == "depth of field":
        return LIT_MIRROR, 4
    if feature == "lights":
        return LIT_MIRROR.replace(_DOF_CAMERA, _SIMPLE_CAMERA), 4
    if feature == "mirror":
        return (LIT_MIRROR.replace(_DOF_CAMERA, _SIMPLE_CAMERA)
                .replace(_LIGHTS, "lights: []\n  ")), 4
    sphere = {
        "fresnel": """material: FresnelMaterial { diffuse: rgb(0.1,0.25,0.6)
        specular: rgb(0.8,0.8,0.85) exponent: 48 ambient: rgb(0,0,0)
        ior: 1.4 } }""",
        "transparent": """material: TransparentMaterial {
        specular: rgb(0.9,0.9,0.9) exponent: 8 ior: 1.5 } }""",
        "fan-out": """material: IndirectPhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(1,1,1)
        samples: 4 } }""",
    }[feature]
    return LIT_MIRROR.replace(_SPHERE, sphere), (4 if feature == "fresnel"
                                                 else 2)


# feature: (kernel, children_per_ray, DFS nodes per lane)
IN_SLICE = {"depth of field": (megakernel.KERNEL_LINEAR, 1, 6),
            "lights": (megakernel.KERNEL_LINEAR, 1, 6),
            "mirror": (megakernel.KERNEL_LINEAR, 1, 6),
            "fresnel": (megakernel.KERNEL_LINEAR, 1, 6),
            "transparent": (megakernel.KERNEL_TREE, 2, 15),
            "fan-out": (megakernel.KERNEL_TREE, 5, 85)}


@pytest.mark.parametrize("feature", list(IN_SLICE))
def test_in_slice_matches_jax_kernel(feature, monkeypatch):
    """The port's radiance_lanes on the CPU against the JAX package's
    megakernel in interpret mode, on 400 lanes of a scene that exercises
    one feature of the slice.  The port's rule (99% of lanes within
    1e-4*max(1,|ref|), means within 1e-3) and, at least as strict, the
    JAX package's own rule for the same regime (97% of lanes within
    isclose at rtol 1e-5/atol 1e-6 for linear chains, 1e-4/1e-5 for
    trees, tests/test_megakernel.py)."""
    from raytrace_tpu.render.integrator import tree_nodes
    from raytrace_tpu.scene import dsl as jdsl
    from raytrace_tpu.scene.builder import build_scene as jax_build
    from raytrace_tpu_torch.render.integrator import tree_loop_stack
    from raytrace_tpu_torch.scene import dsl as tdsl
    from raytrace_tpu_torch.scene.builder import build_scene as torch_build

    monkeypatch.setenv("RAYTRACE_TPU_MEGAKERNEL_INTERPRET", "1")
    text, max_depth = in_slice_scene(feature)
    js = jax_build(jdsl.parse(text), dtype=jnp.float32)
    ts = torch_build(tdsl.parse(text), device="cpu")
    js = dataclasses.replace(js, spec=dataclasses.replace(
        js.spec, max_depth=max_depth))
    ts = dataclasses.replace(ts, spec=dataclasses.replace(
        ts.spec, max_depth=max_depth))
    kernel, branching, nodes = IN_SLICE[feature]
    assert megakernel.usable(ts.data, ts.spec)
    assert megakernel.kernel_for(ts.spec) == kernel
    assert ts.spec.children_per_ray == branching
    assert (tree_loop_stack(ts.spec)[2] == tree_nodes(js.spec) == nodes
            or kernel == megakernel.KERNEL_LINEAR)
    assert jax_mk.usable(js.data, js.spec)

    rs = np.random.RandomState(7)
    n = 400
    lanes = (rs.randint(0, 32, n), rs.randint(0, 32, n), rs.randint(0, 2, n),
             rs.randint(0, ts.spec.cam_samples, n))
    want = jax_mk.radiance_lanes(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes), 5)
    got = megakernel.radiance_lanes(
        ts.data, ts.spec, *(torch.from_numpy(a.astype(np.int64))
                            for a in lanes), 5)
    g = torch.stack(list(got)).double().numpy()
    w = np.stack([np.asarray(x, np.float64) for x in want])
    assert_radiance_close(g, w)
    rtol, atol = ((1e-5, 1e-6) if kernel == megakernel.KERNEL_LINEAR
                  else (1e-4, 1e-5))
    assert np.isclose(g, w, rtol=rtol, atol=atol).mean(axis=1).min() > 0.97
    assert g.max() > 0.0


def test_gradients_not_ported():
    """(The name dates from when this tested the refusal.)  A scene that
    requires grad goes through radiance_lanes, and the gradient is the
    plain version's."""
    ts = torch_load(CORNELL, device="cpu")
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in _lanes(64, 5)]
    grads = []
    for fn in (megakernel.radiance_lanes, megakernel.radiance_lanes_reference):
        leaf = ts.data.mat_diffuse.clone().requires_grad_(True)
        data = dataclasses.replace(ts.data, mat_diffuse=leaf)
        out = fn(data, ts.spec, *lanes, 0)
        grads.append(torch.autograd.grad(out.x.sum() + out.y.sum(), leaf)[0])
    assert torch.equal(grads[0], grads[1])
    assert torch.isfinite(grads[0]).all() and grads[0].abs().max() > 0


def test_cpu_dispatch_is_the_plain_version():
    ts = torch_load(CORNELL, device="cpu")
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in _lanes(256, 5)]
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(ts.data, ts.spec, *lanes, 5)
    want = megakernel.radiance_lanes_reference(ts.data, ts.spec, *lanes, 5)
    assert megakernel.LAUNCHES == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        megakernel.radiance_lanes(ts.data, ts.spec, lanes[0][:3], *lanes[1:],
                                  5)


def test_pack_scene_layout():
    """The buffer the CUDA kernels read (csrc/render_common.cuh): a
    24-float header, 16 floats per light, 24 per live object
    (tests/test_torch_k1_layout.py holds the column a small scene's row
    precomputes)."""
    ts = torch_load(SHOWCASE, device="cpu")
    d = ts.data
    buf = megakernel.pack_scene(d, ts.spec)
    assert buf.dtype == torch.float32 and buf.shape == (24 + 16 * 3 + 24 * 4,)
    assert torch.equal(buf[0:3], d.cam_position)
    assert torch.equal(buf[3:12], d.cam_matrix.reshape(9))
    assert torch.equal(buf[12:15], d.bg_color)
    np.testing.assert_array_equal(
        buf[15:19].numpy(),
        np.float32([320.0, 200.0, 1 / 200.0, schema.MIN_SIGNIFICANCE]))
    assert buf[19:24].tolist() == [d.cam_focus.item(), d.cam_aperture.item(),
                                   d.cam_im_dist.item(), 0.0, 0.0]
    lights = buf[24:24 + 48].reshape(3, 16)
    assert lights[:, 0].tolist() == [schema.LIGHT_POINT,
                                     schema.LIGHT_DIRECTIONAL,
                                     schema.LIGHT_AREA]
    for j, leaf in enumerate((d.light_p, d.light_e1, d.light_e2,
                              d.light_color)):
        assert torch.equal(lights[:, 1 + 3 * j:4 + 3 * j], leaf)
    assert not lights[:, 13:].any()
    rows = buf[24 + 48:].reshape(4, 24)
    assert torch.equal(rows[:, :22], object_table(d, ts.spec))
    assert rows[:, 22].all() and not rows[:, 23].any()
    # cornell: no lights, simple camera, every row IndirectPhong
    tc = torch_load(CORNELL, device="cpu")
    buf = megakernel.pack_scene(tc.data, tc.spec)
    assert buf.shape == (24 + 24 * 7,)
    assert buf[24:].reshape(7, 24)[:, 20].tolist() == [1.0] * 7


def test_scene_buffer_follows_the_scene():
    """The packed buffer is reused while the same, unmodified tensors come
    with an equal spec, and packed anew when any of them changes."""
    ts = torch_load(SHOWCASE, device="cpu")
    buf = megakernel._scene_buffer(ts.data, ts.spec)
    assert megakernel._scene_buffer(ts.data, ts.spec) is buf
    assert megakernel._scene_buffer(
        ts.data, dataclasses.replace(ts.spec)) is buf
    wider = dataclasses.replace(ts.spec, width=2 * ts.spec.width)
    assert megakernel._scene_buffer(ts.data, wider)[15] == 640.0
    ts.data.cam_position.add_(1.0)    # in place: same tensor, new version
    moved = megakernel._scene_buffer(ts.data, ts.spec)
    assert moved is not buf and torch.equal(moved[:3], buf[:3] + 1.0)
    copy = dataclasses.replace(ts.data, bg_color=ts.data.bg_color * 0.5)
    half = megakernel._scene_buffer(copy, ts.spec)
    assert torch.equal(half[12:15], buf[12:15] * 0.5)
    assert torch.equal(half, megakernel.pack_scene(copy, ts.spec))


def test_import_pulls_in_no_jax_and_builds_nothing():
    build = _build.BUILD_DIR
    before = sorted(os.listdir(build)) if os.path.isdir(build) else None
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(REPO_ROOT)!r})\n"
        "import raytrace_tpu_torch as p\n"
        "assert not [k for k in sys.modules if k.startswith("
        "'raytrace_tpu_torch.')]\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'raytrace_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "from raytrace_tpu_torch.ops import _build\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'raytrace_tpu')]\n"
        "for m in ('scene.procedural', 'ops.intersect_scan', 'optim',\n"
        "          'models.backgrounds', 'ops.kernel_grad', 'parallel.mesh',\n"
        "          'parallel.tile', 'parallel.multihost', 'parallel.ring',\n"
        "          'utils.profiling', 'utils.gpu_info', 'utils.flops',\n"
        "          'bench', 'entry'):\n"
        "    assert 'raytrace_tpu_torch.' + m in sys.modules, m\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()\n"
        "print(len(mods), bad, _build.loaded())\n")
    r = subprocess.run([sys.executable, "-I", "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    n_mods, rest = r.stdout.split(" ", 1)
    assert int(n_mods) >= 32
    assert rest.strip() == "[] []"
    after = sorted(os.listdir(build)) if os.path.isdir(build) else None
    assert after == before


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _on_card_check(ts, lanes, kernel, seed):
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(ts.data, ts.spec, *lanes, seed)
    want = megakernel.radiance_lanes_reference(ts.data, ts.spec, *lanes, seed)
    torch.cuda.synchronize()
    assert {k: megakernel.LAUNCHES[k] - before[k] for k in megakernel.KERNELS} \
        == {k: int(k == kernel) for k in megakernel.KERNELS}
    assert_radiance_close(torch.stack(list(got)).double().cpu().numpy(),
                          torch.stack(list(want)).double().cpu().numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(cuda_device):
    ts = torch_load(CORNELL, device=cuda_device)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device)
             for a in _lanes(8192, 7)]
    _on_card_check(ts, lanes, megakernel.KERNEL_LINEAR, 7)


@pytest.mark.cuda
def test_lit_kernel_matches_plain_version_on_card(cuda_device):
    """K1 with lights, shadows, the mirror child and depth of field."""
    from raytrace_tpu_torch.scene import dsl as tdsl
    from raytrace_tpu_torch.scene.builder import build_scene as torch_build

    ts = torch_build(tdsl.parse(LIT_MIRROR), device=cuda_device)
    rs = np.random.RandomState(8)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 32, 8192), rs.randint(0, 32, 8192),
        rs.randint(0, 2, 8192), rs.randint(0, 2, 8192))]
    _on_card_check(ts, lanes, megakernel.KERNEL_LINEAR, 8)


@pytest.mark.cuda
def test_tree_kernel_matches_plain_version_on_card(cuda_device):
    """K3 on the materials showcase (63 nodes, m = 2)."""
    ts = torch_load(SHOWCASE, device=cuda_device)
    rs = np.random.RandomState(9)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 640, 8192), rs.randint(0, 400, 8192),
        rs.randint(0, 64, 8192), rs.randint(0, 4, 8192))]
    _on_card_check(ts, lanes, megakernel.KERNEL_TREE, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("samples, max_depth", [(8, 2), (24, 1)])
def test_tree_kernel_deep_stacks_on_card(cuda_device, samples, max_depth):
    """K3's two largest stack sizes: m = 8 at max_depth 2 (22 entries, the
    32-entry instance) and m = 24 at max_depth 1 (47, the 64-entry one)."""
    from raytrace_tpu_torch.render.integrator import tree_loop_stack
    from raytrace_tpu_torch.scene import dsl as tdsl
    from raytrace_tpu_torch.scene.builder import build_scene as torch_build

    text = in_slice_scene("fan-out")[0].replace("samples: 4",
                                                f"samples: {samples}")
    ts = torch_build(tdsl.parse(text), device=cuda_device)
    ts = dataclasses.replace(ts, spec=dataclasses.replace(
        ts.spec, max_depth=max_depth))
    assert tree_loop_stack(ts.spec)[3] in (22, 47)
    rs = np.random.RandomState(10)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 32, 2048), rs.randint(0, 32, 2048),
        rs.randint(0, 2, 2048), rs.randint(0, 2, 2048))]
    _on_card_check(ts, lanes, megakernel.KERNEL_TREE, 10)


@pytest.mark.cuda
def test_card_raises_out_of_slice(cuda_device):
    """On CUDA tensors a scene outside the slice raises, naming its ROADMAP
    item; nothing there gives way to the plain version."""
    lanes = [torch.zeros(4, dtype=torch.int64, device=cuda_device)] * 4
    for data, spec, item in _out_of_slice().values():
        before = dict(megakernel.LAUNCHES)
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP item {item}\\b"):
            megakernel.radiance_lanes(data.to(cuda_device), spec, *lanes, 0)
        assert megakernel.LAUNCHES == before
