"""Skybox scenes in the PyTorch port against the JAX package: the lookup
itself, texture loading, build_scene's skybox branch, and the slice as a
whole (radiance_lanes on the CPU against the JAX megakernel's deferred
miss records and post-pass, in interpret mode)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import backgrounds as jax_bg
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.render import megakernel as jax_mk
from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import build_scene as jax_build
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu.scene.builder import load_texture as jax_load_texture
from raytrace_tpu.scene.schema import BG_SKYBOX as JAX_BG_SKYBOX
from raytrace_tpu_torch import cli, color
from raytrace_tpu_torch.io.bmp import read_bmp, write_bmp
from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load
from raytrace_tpu_torch.scene.builder import load_texture
from raytrace_tpu_torch.scene.schema import (BG_SKYBOX, SceneData,
                                             SceneSpec,
                                             scene_data_from_numpy)

from conftest import repo_path
from test_torch_megakernel import LIT_MIRROR, assert_radiance_close

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))

# six faces of six sizes in one padded cube (tests/test_integrator.py:162)
SIZES = ((3, 5), (4, 4), (2, 2), (4, 3), (3, 3), (5, 5))
FIELDS = [f.name for f in dataclasses.fields(SceneData)]


def _cube(sizes, seed, dtype=np.float64):
    rs = np.random.RandomState(seed)
    cube = np.zeros((6, max(h for h, _ in sizes), max(w for _, w in sizes),
                     3), dtype)
    for i, (h, w) in enumerate(sizes):
        cube[i, :h, :w] = rs.rand(h, w, 3)
    return cube


def _directions(n, seed):
    """Random directions, with exact ties for the largest component,
    zero components, axis-aligned and all-zero directions among them."""
    rs = np.random.RandomState(seed)
    rd = rs.normal(size=(n, 3))
    rd[:100, 0] = rd[:100, 1]                    # |dx| == |dy|, the largest
    rd[:100, 2] = 0.3 * rd[:100, 1]
    rd[100:200, 1] = -rd[100:200, 2]             # |dy| == |dz|, the largest
    rd[100:200, 0] = 0.3 * rd[100:200, 2]
    rd[200:300, 2] = 0.0
    rd[300:400, (0, 1)] = 0.0                          # along z
    rd[400:410] = (np.eye(3)[rs.randint(0, 3, 10)]
                   * rs.choice([-1, 1], 10)[:, None])
    rd[410:420] = 0.0
    rd[420:430] = 1.0                                  # a three-way tie
    return rd


def _specs(sizes):
    kw = dict(shape_type=(0,), mat_type=(0,), light_type=(), face_sizes=sizes)
    from raytrace_tpu.scene.schema import SceneSpec as JaxSpec

    return (JaxSpec(bg_type=JAX_BG_SKYBOX, **kw),
            SceneSpec(bg_type=BG_SKYBOX, **kw))


class _Cube:
    """What the JAX lookup reads of its scene."""

    def __init__(self, cube):
        self.bg_cube = cube


@pytest.mark.parametrize("name, tol", [("float64", 1e-12), ("float32", 1e-6)])
def test_skybox_matches_jax(name, tol):
    """The lookup on 20,000 directions over six faces of six sizes."""
    jspec, tspec = _specs(SIZES)
    cube, rd = _cube(SIZES, 0), _directions(20000, 1)
    want = np.asarray(jax_bg._skybox(
        _Cube(jnp.asarray(cube, name)), jspec, jnp.asarray(rd, name)))
    tdt = getattr(torch, name)
    got = backgrounds._skybox(torch.tensor(cube, dtype=tdt), tspec,
                              torch.tensor(rd, dtype=tdt))
    assert got.dtype == tdt and got.shape == (20000, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    # ties for the largest component and zero directions are black
    ties = np.r_[0:200, 410:430]
    assert not got[ties].any() and got.abs().sum() > 0
    assert (got[200:410].sum(dim=1) > 0).all()


def test_skybox_ignores_the_padding():
    """A face is clamped to its own size: texels of the padding, here
    set to 1000, never reach a color."""
    _, tspec = _specs(SIZES)
    cube = _cube(SIZES, 2)
    loud = np.full_like(cube, 1000.0)
    for i, (h, w) in enumerate(SIZES):
        loud[i, :h, :w] = cube[i, :h, :w]
    rd = torch.tensor(_directions(5000, 3))
    got = backgrounds._skybox(torch.tensor(loud), tspec, rd)
    assert torch.equal(got, backgrounds._skybox(torch.tensor(cube), tspec,
                                                rd))
    assert float(got.max()) <= 1.0


@pytest.mark.parametrize("bg", ["skybox", "solid"])
def test_background_color_matches_jax(bg):
    """Both public forms, (N, 3) rows and V3 components, on the CPU."""
    jspec, tspec = _specs(SIZES)
    if bg == "solid":
        jspec = dataclasses.replace(jspec, bg_type=0)
        tspec = dataclasses.replace(tspec, bg_type=0)
    cube, rd = _cube(SIZES, 4, np.float32), _directions(2000, 5)
    rd = rd.astype(np.float32)
    color_ = np.float32([0.1, 0.5, 0.9])

    class JD:
        bg_cube, bg_color = jnp.asarray(cube), jnp.asarray(color_)

    ts = torch_load(CORNELL, device="cpu")
    data = dataclasses.replace(ts.data, bg_cube=torch.tensor(cube),
                               bg_color=torch.tensor(color_))
    want = np.asarray(jax_bg.background_color(JD, jspec, jnp.asarray(rd)))
    before = dict(_build.LAUNCHES)
    got = backgrounds.background_color(data, tspec, torch.tensor(rd))
    assert _build.LAUNCHES == before        # CPU tensors: the plain version
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want_v = jax_bg.background_color_v(JD, jspec, JV3(*jnp.asarray(rd).T))
    got_v = backgrounds.background_color_v(data, tspec,
                                           V3(*torch.tensor(rd).T))
    for g, w in zip(got_v, want_v):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def _write_face(path, h, w, seed):
    """An (h, w) sRGB image from a seed, written as a BMP; returns the
    bytes top row first."""
    rgb = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(
        np.uint8)
    write_bmp(str(path), rgb[::-1])     # write_bmp takes the bottom row first
    return rgb


@pytest.mark.parametrize("h, w", [(5, 7), (4, 4), (1, 1), (3, 2), (6, 9)])
def test_load_texture_matches_jax(tmp_path, h, w):
    """BMP faces written by io/bmp.py, read with numpy alone: the JAX
    package's array (Pillow's decoding), to the bit, for widths with and
    without row padding."""
    path = tmp_path / "face.bmp"
    rgb = _write_face(path, h, w, h * 10 + w)
    got = load_texture(str(path))
    assert got.dtype == np.float64 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, jax_load_texture(str(path)))
    np.testing.assert_array_equal(got, color.SRGB_VALUES[rgb])
    np.testing.assert_array_equal(read_bmp(str(path))[::-1], rgb)


def test_load_texture_top_down_bmp(tmp_path):
    """A negative height stores the top row first."""
    path = tmp_path / "face.bmp"
    rgb = _write_face(path, 3, 5, 7)
    blob = bytearray(path.read_bytes())
    blob[22:26] = (-3).to_bytes(4, "little", signed=True)
    rows = np.frombuffer(bytes(blob[122:]), np.uint8).reshape(3, -1)
    blob[122:] = rows[::-1].tobytes()
    path.write_bytes(bytes(blob))
    np.testing.assert_array_equal(load_texture(str(path)),
                                  color.SRGB_VALUES[rgb])


def test_load_texture_other_formats_take_pillow(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    rgb = np.random.RandomState(6).randint(0, 256, (4, 6, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(tmp_path / "face.png")
    # a top-down BMP (negative height) and one with a palette go the same way
    Image.fromarray(rgb).convert("P").save(tmp_path / "pal.bmp")
    for name in ("face.png", "pal.bmp"):
        np.testing.assert_array_equal(
            load_texture(str(tmp_path / name)),
            jax_load_texture(str(tmp_path / name)))


@pytest.mark.parametrize("what", ["missing", "not an image"])
def test_load_texture_errors_like_jax(tmp_path, what):
    path = tmp_path / "nope.bmp"
    if what == "not an image":
        path.write_bytes(b"BM but not a bitmap")
    with pytest.raises(jdsl.SceneSyntaxError) as want:
        jax_load_texture(str(path))
    with pytest.raises(tdsl.SceneSyntaxError) as got:
        load_texture(str(path))
    head = f'0:0: error loading "{path}": '
    assert str(got.value).startswith(head) and str(want.value).startswith(head)
    if what == "missing":
        assert str(got.value) == str(want.value)


FACES = ("px", "nx", "py", "ny", "pz", "nz")


def _skybox_scene_file(tmp_path, objects="", width=16, height=16):
    """A scene file with a SkyboxBackground whose six faces, of six
    sizes, lie beside it as BMPs under relative paths."""
    (tmp_path / "sky").mkdir()
    for i, (name, (h, w)) in enumerate(zip(FACES, SIZES)):
        _write_face(tmp_path / "sky" / f"{name}.bmp", h, w, 20 + i)
    loads = " ".join(f'{n}: load("sky/{n}.bmp")' for n in FACES)
    text = f"""{{ objects: [ {objects} ] lights: []
  camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 1)
  background: SkyboxBackground {{ {loads} }}
  options: {{ width: {width} height: {height} antialias: 2 }} }}"""
    path = tmp_path / "scene.txt"
    path.write_text(text)
    return path


MIRROR_BALL = """{ bounds: Sphere { center: (0, 0, -3) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.2,0.2,0.2)
        specular: rgb(0.8,0.8,0.8) exponent: 16 ambient: rgb(0,0,0) } }"""


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_builder_skybox_matches_jax(tmp_path, dtype):
    path = _skybox_scene_file(tmp_path, MIRROR_BALL)
    js = jax_load(str(path), dtype=getattr(jnp, dtype))
    ts = torch_load(str(path), device="cpu", dtype=getattr(torch, dtype))
    assert dataclasses.asdict(ts.spec) == dataclasses.asdict(js.spec)
    assert ts.spec.bg_type == BG_SKYBOX and ts.spec.face_sizes == SIZES
    assert ts.data.bg_cube.shape == (6, 5, 5, 3)
    for n in FIELDS:
        np.testing.assert_array_equal(getattr(ts.data, n).numpy(),
                                      np.asarray(getattr(js.data, n)),
                                      err_msg=n)
    # the leaves cross devices and numpy as the others do
    moved = ts.data.to("cpu")
    again = scene_data_from_numpy(
        {n: np.asarray(getattr(js.data, n)) for n in FIELDS}, "cpu",
        getattr(torch, dtype))
    assert torch.equal(moved.bg_cube, ts.data.bg_cube)
    assert torch.equal(again.bg_cube, ts.data.bg_cube)


def test_builder_skybox_missing_face(tmp_path):
    path = _skybox_scene_file(tmp_path)
    (tmp_path / "sky" / "pz.bmp").unlink()
    with pytest.raises(tdsl.SceneSyntaxError, match="error loading"):
        torch_load(str(path), device="cpu")
    # without a scene directory a relative path is taken as it stands
    with pytest.raises(tdsl.SceneSyntaxError, match='"sky/px.bmp"'):
        torch_build(tdsl.parse(path.read_text()), device="cpu")


def _with_sky(js, ts, cube, sizes):
    """The same cube injected into a JAX scene and its port."""
    js = dataclasses.replace(
        js, data=dataclasses.replace(js.data, bg_cube=jnp.asarray(cube)),
        spec=dataclasses.replace(js.spec, bg_type=JAX_BG_SKYBOX,
                                 face_sizes=sizes))
    ts = dataclasses.replace(
        ts, data=dataclasses.replace(ts.data, bg_cube=torch.tensor(cube)),
        spec=dataclasses.replace(ts.spec, bg_type=BG_SKYBOX,
                                 face_sizes=sizes))
    return js, ts


def _mirror_field_text(n=70):
    """A linear field past the large-scene threshold whose every ray
    ends in the sky: Phong mirror spheres over a matte floor, no lights."""
    rs = np.random.RandomState(3)
    objs = ["""
    { bounds: Plane { point: (0, -2, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6, 0.6, 0.6)
        specular: rgb(0.2,0.2,0.2) exponent: 1 ambient: rgb(0.01,0.01,0.01) } }"""]
    for _ in range(n):
        c = rs.uniform(-8, 8, 3) + [0, 0, -14]
        objs.append(f"""
    {{ bounds: Sphere {{ center: ({c[0]:.2f}, {c[1]:.2f}, {c[2]:.2f})
         radius: {rs.uniform(0.3, 0.8):.2f} }}
      material: PhongMaterial {{ diffuse: rgb(0.3, 0.3, 0.3)
        specular: rgb({rs.uniform(0.3, 0.9):.2f}, 0.6, 0.5) exponent: 8
        ambient: rgb(0.02,0.02,0.02) }} }}""")
    return f"""{{ objects: [ {''.join(objs)} ] lights: []
      camera: SimplePerspectiveCamera new(
          (0, 2, 6), (0, -0.2, -1), (0, 1, 0), 2.0)
      background: SolidColorBackground {{ color: rgb(0, 0, 0) }}
      options: {{ width: 32 height: 32 antialias: 2 }} }}"""


def _slice_scenes(case):
    """(JAX scene, port's scene, kernel) of the skybox scenes of the JAX
    package's kernel tests: a pure-diffuse linear scene
    (tests/test_megakernel.py:271), a Transparent sphere at max_depth 2,
    a 15-node tree (:313), and for the large regime 70 mirror spheres
    over a floor under the open sky at max_depth 1.  (The JAX package's
    large skybox scene, tests/test_megakernel_large.py:242, is a sphere
    field in a closed box, where no ray reaches the sky.)"""
    if case == "large":
        text = _mirror_field_text()
        js = jax_build(jdsl.parse(text), dtype=jnp.float32)
        ts = torch_build(tdsl.parse(text), device="cpu")
        depth, sizes, seed = 1, ((4, 4),) * 6, 21
        kernel = megakernel.KERNEL_LINEAR
    else:
        if case == "linear":
            text = LIT_MIRROR.replace("specular: rgb(0.3,0.3,0.3)",
                                      "specular: rgb(0,0,0)").replace(
                                      "specular: rgb(0.4,0.4,0.4)",
                                      "specular: rgb(0,0,0)")
            depth, sizes, seed = 4, ((4, 4),) * 6, 5
            kernel = megakernel.KERNEL_LINEAR
        else:
            text = LIT_MIRROR.replace(
                """material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }""",
                """material: TransparentMaterial { specular: rgb(0.9,0.9,0.9)
        exponent: 8 ior: 1.5 } }""")
            assert "Transparent" in text
            depth, sizes, seed = 2, SIZES, 11
            kernel = megakernel.KERNEL_TREE
        js = jax_build(jdsl.parse(text), dtype=jnp.float32)
        ts = torch_build(tdsl.parse(text), device="cpu")
    cube = _cube(sizes, seed, np.float32)
    if case == "large":
        # a mirror 20 units away turns float32's last bits of the normal
        # into 1e-4 of direction, and 4 x 4 faces of noise in [0, 1)
        # would triple that in the color (both packages then sit 0.8-1.0%
        # of lanes outside the rule against a float64 render): a sky of
        # gentler contrast keeps the comparison about the lookup
        cube = 0.4 + 0.2 * cube
    js, ts = _with_sky(js, ts, cube, sizes)
    js = dataclasses.replace(js, spec=dataclasses.replace(js.spec,
                                                          max_depth=depth))
    ts = dataclasses.replace(ts, spec=dataclasses.replace(ts.spec,
                                                          max_depth=depth))
    return js, ts, kernel


@pytest.mark.parametrize("case", ["linear", "fan-out", "large"])
def test_skybox_slice_matches_jax_kernel(case, monkeypatch):
    """The slice as a whole: the port's radiance_lanes on the CPU, where
    the lookup runs at every miss, against the JAX megakernel in interpret
    mode, which defers its misses to a post-pass; the port's per-lane
    rule (99% of lanes within 1e-4*max(1,|ref|), means within 1e-3, no
    NaN or inf)."""
    monkeypatch.setenv("RAYTRACE_TPU_MEGAKERNEL_INTERPRET", "1")
    js, ts, kernel = _slice_scenes(case)
    assert jax_mk.usable(js.data, js.spec)
    assert megakernel.usable(ts.data, ts.spec)
    assert megakernel.kernel_for(ts.spec) == kernel
    assert megakernel.is_large(ts.spec) == (case == "large")
    rs = np.random.RandomState(9)
    n = 384
    lanes = (rs.randint(0, ts.spec.width, n), rs.randint(0, ts.spec.height, n),
             rs.randint(0, 2, n), rs.randint(0, ts.spec.cam_samples, n))
    want = jax_mk.radiance_lanes(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes), 9)
    before = dict(_build.LAUNCHES)
    got = megakernel.radiance_lanes(
        ts.data, ts.spec, *(torch.from_numpy(a.astype(np.int64))
                            for a in lanes), 9)
    assert _build.LAUNCHES == before
    g = torch.stack(list(got)).double().numpy()
    w = np.stack([np.asarray(x, np.float64) for x in want])
    assert_radiance_close(g, w)
    # the sky is seen: lanes differ, and a black cube changes the result
    assert g.std() > 0.01
    dark = dataclasses.replace(ts.data,
                               bg_cube=torch.zeros_like(ts.data.bg_cube))
    assert not torch.equal(
        megakernel.radiance_lanes(dark, ts.spec, *(
            torch.from_numpy(a.astype(np.int64)) for a in lanes), 9).x, got.x)


def test_pack_scene_leaves_the_cube_out():
    """The cube stays where it is (six faces of 1024 x 1024 are 75.5 MB):
    the packed buffer of a skybox scene has the solid scene's size, and
    the kernels' face-size argument refuses a cube they cannot read."""
    _, ts, _ = _slice_scenes("fan-out")
    solid = dataclasses.replace(ts.spec, bg_type=0)
    assert (megakernel.pack_scene(ts.data, ts.spec).shape
            == megakernel.pack_scene(ts.data, solid).shape)
    with pytest.raises(ValueError, match="CUDA"):
        backgrounds.face_sizes_arg(ts.data.bg_cube, ts.spec)


def test_cli_cpu_renders_skybox_scene(tmp_path):
    """Scene file and BMP faces to BMP, on the CPU: the sky fills the
    image around a mirror ball, through no kernel."""
    path = _skybox_scene_file(tmp_path, MIRROR_BALL)
    out, log = tmp_path / "out.bmp", tmp_path / "log.jsonl"
    rc = cli.main([str(path), "-o", str(out), "--device", "cpu", "-q",
                   "--log-json", str(log)])
    assert rc == 0
    done = [json.loads(x) for x in log.read_text().splitlines()
            if '"render_done"' in x][-1]
    assert done["nonfinite"] == 0 and done["kernel_launches"] == 0
    assert done["mean_radiance"] > 0.05
    img = read_bmp(str(out))
    assert img.shape == (16, 16, 3) and img.std() > 5


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_skybox_kernel_matches_plain_version_on_card(cuda_device):
    """csrc/skybox.cu against _skybox on 262,144 directions: within 1e-6
    on at least 99.9% of them, ties black in both."""
    _, tspec = _specs(SIZES)
    ts = torch_load(CORNELL, device=cuda_device)
    data = dataclasses.replace(ts.data, bg_cube=torch.tensor(
        _cube(SIZES, 0, np.float32), device=cuda_device))
    rd = torch.tensor(_directions(1 << 18, 1).astype(np.float32),
                      device=cuda_device)
    before = _build.LAUNCHES[_build.KERNEL_SKY]
    got = backgrounds.background_color(data, tspec, rd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[_build.KERNEL_SKY] == before + 1
    want = backgrounds._skybox(data.bg_cube, tspec, rd)
    assert torch.isfinite(got).all()
    close = ((got - want).abs() <= 1e-6).all(dim=1).float().mean()
    assert close >= 0.999, close
    assert not got[:200].any() and not want[:200].any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["linear", "fan-out", "large"])
def test_sky_instances_match_plain_version_on_card(cuda_device, case):
    _, ts, kernel = _slice_scenes(case)
    data = ts.data.to(cuda_device)
    rs = np.random.RandomState(13)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, ts.spec.width, 8192),
        rs.randint(0, ts.spec.height, 8192), rs.randint(0, 2, 8192),
        rs.randint(0, ts.spec.cam_samples, 8192))]
    before = _build.LAUNCHES[kernel]
    got = megakernel.radiance_lanes(data, ts.spec, *lanes, 13)
    want = megakernel.radiance_lanes_reference(data, ts.spec, *lanes, 13)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[kernel] == before + 1
    assert_radiance_close(torch.stack(list(got)).double().cpu().numpy(),
                          torch.stack(list(want)).double().cpu().numpy())
