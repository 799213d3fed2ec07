"""Scene parity of the PyTorch port: DSL, builder and schema against the
JAX package on the same scene files."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load
from raytrace_tpu_torch.scene.schema import SceneData, scene_data_from_numpy

from conftest import repo_path

SCENES = ["cornell_indirect.txt", "materials_showcase.txt"]
FIELDS = [f.name for f in dataclasses.fields(SceneData)]

MALFORMED = [
    "{ objects: [ } ",
    "{ objects: [] lights: [] camera: Nope {} }",
    '{ "unterminated',
    "{ objects: [ { bounds: Sphere { center: (0, 0, 0) } } ] }",
    "{ objects: [] lights: [] foo: 1 }",
]

SKYBOX = """{ objects: [] lights: []
  camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
  background: SkyboxBackground { px: load("a.png") nx: load("b.png")
    py: load("c.png") ny: load("d.png") pz: load("e.png") nz: load("f.png") }
  options: { width: 4 height: 4 antialias: 1 } }"""


def _text(name):
    return repo_path("examples", name).read_text()


@pytest.mark.parametrize("name", SCENES)
def test_dsl_ast_equal(name):
    text = _text(name)
    assert repr(tdsl.parse(text)) == repr(jdsl.parse(text))
    assert ([t.kind for t in tdsl.tokenize(text)]
            == [t.kind for t in jdsl.tokenize(text)])


@pytest.mark.parametrize("src", MALFORMED)
def test_dsl_errors_equal(src):
    with pytest.raises(jdsl.SceneSyntaxError) as want:
        jdsl.parse(src)
    with pytest.raises(tdsl.SceneSyntaxError) as got:
        tdsl.parse(src)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", SCENES)
def test_builder_leaves_exact(name):
    path = str(repo_path("examples", name))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
    assert ts.spec.children_per_ray == js.spec.children_per_ray
    assert ts.spec.max_live_children == js.spec.max_live_children
    assert ts.spec.n_objects == js.spec.n_objects
    for name_ in FIELDS:
        want = np.asarray(getattr(js.data, name_))
        got = getattr(ts.data, name_)
        assert got.dtype == torch.float32, name_
        assert got.numpy().dtype == want.dtype, name_
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name_)


def test_scene_data_from_numpy_matches_builder():
    path = str(repo_path("examples", "cornell_indirect.txt"))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    data = scene_data_from_numpy(
        {n: np.asarray(getattr(js.data, n)) for n in FIELDS}, "cpu",
        torch.float32)
    for n in FIELDS:
        assert torch.equal(getattr(data, n), getattr(ts.data, n)), n
    moved = data.to("cpu")
    assert moved.dtype == torch.float32 and moved.device.type == "cpu"
    assert all(torch.equal(getattr(moved, n), getattr(data, n))
               for n in FIELDS)
    with pytest.raises(KeyError):
        scene_data_from_numpy({"prim_p": np.zeros((1, 3))}, "cpu",
                              torch.float32)


def test_f64_build_is_exact():
    path = str(repo_path("examples", "materials_showcase.txt"))
    js = jax_load(path, dtype=jnp.float64)
    ts = torch_load(path, device="cpu", dtype=torch.float64)
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(ts.data, n).numpy(),
                                      np.asarray(getattr(js.data, n)),
                                      err_msg=n)


def test_skybox_not_ported():
    """(The name dates from when this tested the refusal.)  A scene with
    a SkyboxBackground parses to the JAX package's AST and builds up to
    the first face it cannot read, which is the same error in both."""
    from raytrace_tpu.scene.builder import build_scene as jax_build

    assert repr(tdsl.parse(SKYBOX)) == repr(jdsl.parse(SKYBOX))
    with pytest.raises(jdsl.SceneSyntaxError) as want:
        jax_build(jdsl.parse(SKYBOX))
    with pytest.raises(tdsl.SceneSyntaxError) as got:
        build_scene(tdsl.parse(SKYBOX), device="cpu")
    assert str(got.value) == str(want.value)
    assert 'error loading "a.png"' in str(got.value)


def test_scene_data_from_numpy_carries_showcase_leaves():
    """Every leaf the lit and fan-out path reads (lights, the
    depth-of-field constants, specular, exponent, ior) comes across from
    the JAX package's showcase exactly."""
    js = jax_load(str(repo_path("examples", "materials_showcase.txt")),
                  dtype=jnp.float32)
    data = scene_data_from_numpy(
        {n: np.asarray(getattr(js.data, n)) for n in FIELDS}, "cpu",
        torch.float32)
    for n in ("light_p", "light_e1", "light_e2", "light_color", "cam_focus",
              "cam_aperture", "cam_im_dist", "mat_specular", "mat_exponent",
              "mat_ior"):
        want = np.asarray(getattr(js.data, n))
        got = getattr(data, n)
        assert got.shape == want.shape, n
        np.testing.assert_array_equal(got.numpy(), want, err_msg=n)
    assert data.light_p.shape == (3, 3) and float(data.cam_aperture) > 0


def test_package_root_exports():
    """The package root exports the JAX package's names (each imported on
    first use, so that importing the package imports no submodule)."""
    import raytrace_tpu
    import raytrace_tpu_torch
    from raytrace_tpu_torch.scene import schema

    names = ["SceneData", "SceneSpec", "Scene", "deserialize",
             "SceneSyntaxError"]
    for n in names:
        assert hasattr(raytrace_tpu, n)
        assert getattr(raytrace_tpu_torch, n) is getattr(
            tdsl if n in ("deserialize", "SceneSyntaxError") else schema, n)
    assert raytrace_tpu_torch.__version__ == raytrace_tpu.__version__
    assert sorted(raytrace_tpu_torch.__all__) == sorted(["__version__",
                                                         *names])
    with pytest.raises(AttributeError):
        raytrace_tpu_torch.render_image