"""Large scenes (more than 64 objects) in the PyTorch port against the JAX
package: the procedural sphere fields, the scanned regime of closest-hit
and the shadow query, and the slice as a whole, radiance_lanes on the CPU
against the JAX megakernel's in-kernel table fold in interpret mode."""

import dataclasses
import json
import struct
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops.intersect import _closest_hit_scanned as jax_scanned
from raytrace_tpu.ops.intersect import occluded_v as jax_occluded_v
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.render import megakernel as jax_mk
from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import build_scene as jax_build
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.ops.intersect import (LARGE_SCENE_THRESHOLD,
                                              _closest_hit_scanned,
                                              closest_hit, occluded_v)
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.render.integrator import (_group_cap, _s_p_launch,
                                                  render_image,
                                                  tree_loop_stack)
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build
from raytrace_tpu_torch.scene.procedural import (make_sphere_field,
                                                 sphere_field_source)

from conftest import REPO_ROOT
from test_torch_megakernel import (LANE_RTOL, MIN_LANES_OK,
                                   assert_radiance_close)

FLOAT_FIELDS = ("t", "normal", "pt")
ROW_FIELDS = ("diffuse", "specular", "ambient", "exponent", "ior",
              "msamples", "is_fresnel", "is_transp", "is_indirect")


@pytest.mark.parametrize("mix", [True, False])
def test_sphere_field_matches_jax(mix):
    """make_sphere_field(100): every scene array and every spec field
    equal to the JAX package's, exactly."""
    js = jax_field(100, mix_materials=mix, width=64, height=48, antialias=2,
                   seed=4)
    ts = make_sphere_field(100, mix_materials=mix, width=64, height=48,
                           antialias=2, seed=4, device="cpu")
    for f in dataclasses.fields(ts.data):
        want = np.asarray(getattr(js.data, f.name))
        got = getattr(ts.data, f.name).numpy()
        assert got.dtype == want.dtype == np.float32, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)
    for f in dataclasses.fields(ts.spec):
        assert getattr(ts.spec, f.name) == getattr(js.spec, f.name), f.name
    assert ts.spec.n_objects == 106
    assert ts.spec.children_per_ray == (3 if mix else 1)
    assert sphere_field_source(3, seed=1) != sphere_field_source(3, seed=2)


def _rays(n, seed):
    """Half the rays from around the field's camera into the grid of
    spheres, half from all over the box in every direction."""
    r = np.random.RandomState(seed)
    h = n // 2
    ro = np.concatenate([
        np.repeat([[0.0, 4.0, 28.0]], h, 0) + r.normal(0, 0.5, (h, 3)),
        r.uniform([-28, -9, -28], [28, 28, 28], (n - h, 3))])
    rd = r.normal(0, 1, (n, 3))
    rd[:h] = r.uniform([-8, -9, -20], [8, 5, -5], (h, 3)) - ro[:h]
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _jv3(a):
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _flat(v):
    if isinstance(v, tuple):
        return np.stack([_flat(c)[:, 0] for c in v], 1)
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.float64).reshape(-1, 1)


@pytest.mark.parametrize("mix", [False, True])
def test_closest_hit_large_matches_jax(mix):
    """The scanned regime against the JAX package's _closest_hit_scanned:
    every HitRec field, integers and material rows exact, floats within
    1e-5 on every lane that hits a plane.  On a sphere seen from tens of
    units away the float32 discriminant ``b*b - 4ac`` cancels, so both
    packages sit up to 4e-3 from the float64 answer there and differ from
    each other by as much (XLA contracts the expression into a fused
    multiply-add on the CPU, PyTorch does not).  Those lanes are held
    within 1e-2 of the JAX package, and the port's error against its own
    float64 run to at most twice the JAX package's, at the 99th percentile
    and at the maximum."""
    js = jax_field(100, mix_materials=mix)
    ts = make_sphere_field(100, mix_materials=mix, device="cpu")
    t64 = make_sphere_field(100, mix_materials=mix, device="cpu",
                            dtype=torch.float64)
    assert len(ts.spec.live_objects()) > LARGE_SCENE_THRESHOLD
    ro, rd = _rays(1024, 6)
    want = jax_scanned(js.data, js.spec, _jv3(ro), _jv3(rd))
    got = closest_hit(ts.data, ts.spec, _tv3(ro), _tv3(rd))
    true = closest_hit(t64.data, t64.spec, _tv3(ro.astype(np.float64)),
                       _tv3(rd.astype(np.float64)))
    assert got.obj.dtype == torch.int64
    np.testing.assert_array_equal(got.hit.numpy(), np.asarray(want.hit))
    np.testing.assert_array_equal(got.obj.numpy(), np.asarray(want.obj))
    assert len(set(got.obj.numpy().tolist())) > 30
    plane = np.asarray(ts.spec.shape_type)[got.obj.numpy()] == 1
    assert torch.equal(true.obj, got.obj)
    assert 100 < plane.sum() < 924
    for f in FLOAT_FIELDS:
        g, w = _flat(getattr(got, f)), _flat(getattr(want, f))
        np.testing.assert_allclose(g[plane], w[plane], rtol=1e-5, atol=1e-5,
                                   err_msg=f)
        np.testing.assert_allclose(g, w, rtol=1e-2, atol=1e-2, err_msg=f)
        x = _flat(getattr(true, f))
        err_g = np.abs(g - x).max(axis=1)
        err_w = np.abs(w - x).max(axis=1)
        assert err_g.max() <= 2 * err_w.max(), f
        assert np.percentile(err_g, 99) <= 2 * np.percentile(err_w, 99), f
    for f in ROW_FIELDS:
        np.testing.assert_array_equal(_flat(getattr(got, f)),
                                      _flat(getattr(want, f)), err_msg=f)


def test_large_miss_lanes_take_object_zero():
    """Miss lanes of the scanned regime: object 0 and its row, ior 1."""
    text = sphere_field_source(70).replace(
        "{ bounds: Plane { point: (0, 30, 0)", "{ bounds: Plane { point: "
        "(0, -40, 0)")   # the ceiling below the floor: rays going up escape
    ts = torch_build(tdsl.parse(text), device="cpu")
    ro = V3(*(torch.tensor([v, v]) for v in (0.0, 120.0, 0.0)))
    rd = V3(*(torch.tensor([v, v]) for v in (0.0, 1.0, 0.0)))
    h = closest_hit(ts.data, ts.spec, ro, rd)
    assert not h.hit.any() and (h.obj == 0).all() and torch.isinf(h.t).all()
    assert torch.equal(h.diffuse.x, ts.data.mat_diffuse[0, 0].expand(2))
    assert (h.ior == 1.0).all()
    # lanes of any shape: the scan sees them flat
    ro2 = V3(*(c.reshape(2, 1) for c in ro))
    rd2 = V3(*(c.reshape(2, 1) for c in rd))
    assert closest_hit(ts.data, ts.spec, ro2, rd2).t.shape == (2, 1)


@pytest.mark.parametrize("has_range", [True, False])
def test_occluded_large_matches_jax(has_range):
    js = jax_field(100)
    ts = make_sphere_field(100, device="cpu")
    ro, rd = _rays(1024, 8)
    sq = np.random.RandomState(8).uniform(0.0, 900.0, 1024).astype(np.float32)
    want = np.asarray(jax_occluded_v(js.data, js.spec, _jv3(ro), _jv3(rd),
                                     jnp.asarray(sq), has_range))
    got = occluded_v(ts.data, ts.spec, _tv3(ro), _tv3(rd),
                     torch.from_numpy(sq), has_range).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)
    assert got.mean() > 0.05 and (has_range or got.all())
    if has_range:
        assert not got.all()


def test_scanned_regime_equals_unrolled_regime():
    """One scene just under and just over the threshold (64 and 65
    objects, the extra one out of every ray's way): the scanned regime
    gives the unrolled regime's records, and so does the scanned code on
    the 64-object scene."""
    small = make_sphere_field(58, device="cpu")
    large = make_sphere_field(59, device="cpu")
    assert small.spec.n_objects == 64 and large.spec.n_objects == 65
    # the 59th sphere goes where no ray of the test can reach it
    large.data.prim_p[64] = torch.tensor([0.0, -500.0, 0.0])
    assert torch.equal(large.data.prim_p[:64], small.data.prim_p)
    ro, rd = _rays(1024, 9)
    a = closest_hit(small.data, small.spec, _tv3(ro), _tv3(rd))
    for b in (closest_hit(large.data, large.spec, _tv3(ro), _tv3(rd)),
              _closest_hit_scanned(small.data, small.spec, _tv3(ro),
                                   _tv3(rd))):
        assert torch.equal(a.obj, b.obj) and torch.equal(a.hit, b.hit)
        assert a.hit.all()   # a closed box: the miss rows do not differ
        for f in FLOAT_FIELDS + ROW_FIELDS:
            np.testing.assert_array_equal(_flat(getattr(a, f)),
                                          _flat(getattr(b, f)), err_msg=f)
    sq = torch.full((1024,), 60.0)
    assert torch.equal(
        occluded_v(small.data, small.spec, _tv3(ro), _tv3(rd), sq, True),
        occluded_v(large.data, large.spec, _tv3(ro), _tv3(rd), sq, True))


def _lit_field_text(n=70):
    """A linear Phong sphere field past the threshold with a point and a
    directional light (tests/test_megakernel_large.py:165)."""
    objs = ["""
    { bounds: Plane { point: (0, -2, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6, 0.6, 0.6)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0.01,0.01,0.01) } }"""]
    rng = np.random.RandomState(3)
    for _ in range(n):
        c = rng.uniform(-8, 8, 3) + [0, 0, -14]
        col = rng.uniform(0.2, 1.0, 3)
        objs.append(f"""
    {{ bounds: Sphere {{ center: ({c[0]:.2f}, {c[1]:.2f}, {c[2]:.2f})
         radius: {rng.uniform(0.3, 0.8):.2f} }}
      material: PhongMaterial {{ diffuse: rgb({col[0]:.2f}, {col[1]:.2f},
        {col[2]:.2f}) specular: rgb(0,0,0) exponent: 1
        ambient: rgb(0,0,0) }} }}""")
    return f"""{{
      objects: [ {''.join(objs)} ]
      lights: [
        {{ model: PointLight {{ location: (0, 10, 0) }}
           color: rgb(80, 75, 70) }}
        {{ model: DirectionalLight {{ direction: (-1, -2, -0.5) }}
           color: rgb(0.4, 0.4, 0.5) }}
      ]
      camera: SimplePerspectiveCamera new(
          (0, 2, 6), (0, -0.2, -1), (0, 1, 0), 2.0)
      background: SolidColorBackground {{ color: rgb(0.02, 0.02, 0.04) }}
      options: {{ width: 32 height: 3 antialias: 1 }}
    }}"""


def _slice_scene(case):
    """(scene text, max_depth, kernel) of the large scene of ``case``."""
    if case == "linear field":
        return (sphere_field_source(100, mix_materials=False, width=32,
                                    height=32), 1, megakernel.KERNEL_LINEAR)
    if case == "mixed field":
        return (sphere_field_source(100, mix_materials=True, width=32,
                                    height=32), 1, megakernel.KERNEL_TREE)
    return _lit_field_text(), 4, megakernel.KERNEL_LINEAR


@pytest.mark.parametrize("case", ["linear field", "mixed field", "lit field"])
def test_large_slice_matches_jax_kernel(case, monkeypatch):
    """The slice as a whole: the port's radiance_lanes on the CPU against
    the JAX megakernel in interpret mode (its in-kernel table fold) on a
    100-sphere linear field, a 100-sphere mixed field (fan-out, m = 2)
    and a lit field with shadows, under the port's rule: 99% of lanes
    within 1e-4*max(1,|ref|), no NaN or inf, and the means within 1e-3 on
    the lit field, which has no Monte-Carlo bounce.  On the two fields the
    means are held to 2%, the bound of the JAX package's own test of them
    (tests/test_megakernel_large.py:62): a forked lane there swings
    between the dome's ambient 6 and 0, so the few forks that the
    per-lane rule allows move the mean of some hundred lanes by a percent
    (measured: 0.2-0.6% of 2,048 lanes fork, the means move 0.3-0.6%)."""
    monkeypatch.setenv("RAYTRACE_TPU_MEGAKERNEL_INTERPRET", "1")
    text, max_depth, kernel = _slice_scene(case)
    js = jax_build(jdsl.parse(text), dtype=jnp.float32)
    ts = torch_build(tdsl.parse(text), device="cpu")
    js = dataclasses.replace(js, spec=dataclasses.replace(
        js.spec, max_depth=max_depth))
    ts = dataclasses.replace(ts, spec=dataclasses.replace(
        ts.spec, max_depth=max_depth))
    for f in dataclasses.fields(ts.data):
        np.testing.assert_array_equal(getattr(ts.data, f.name).numpy(),
                                      np.asarray(getattr(js.data, f.name)))
    for f in dataclasses.fields(ts.spec):
        assert getattr(ts.spec, f.name) == getattr(js.spec, f.name), f.name
    assert megakernel.is_large(ts.spec) and megakernel.usable(ts.data, ts.spec)
    assert megakernel.kernel_for(ts.spec) == kernel
    assert jax_mk.usable(js.data, js.spec)
    if case == "mixed field":
        assert tree_loop_stack(ts.spec)[0] == 2
    if case == "lit field":
        assert ts.spec.n_lights == 2

    rs = np.random.RandomState(12)
    n = 384
    lanes = (rs.randint(0, 32, n), rs.randint(0, ts.spec.height, n),
             rs.randint(0, 2, n), np.zeros(n, np.int64))
    want = jax_mk.radiance_lanes(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes), 5)
    t_lanes = [torch.from_numpy(a.astype(np.int64)) for a in lanes]
    before = dict(_build.LAUNCHES)
    got = megakernel.radiance_lanes(ts.data, ts.spec, *t_lanes, 5)
    g = torch.stack(list(got)).double().numpy()
    w = np.stack([np.asarray(x, np.float64) for x in want])
    if case == "lit field":
        assert_radiance_close(g, w)
    else:
        assert np.isfinite(g).all()
        ok = np.abs(g - w) <= LANE_RTOL * np.maximum(1.0, np.abs(w))
        assert ok.all(axis=0).mean() >= MIN_LANES_OK, ok.all(axis=0).mean()
        np.testing.assert_allclose(g.mean(axis=1), w.mean(axis=1), rtol=2e-2)
    assert g.max() > 0.0 and g.std() > 0.01
    # on the CPU the split path is the plain path, and nothing launches
    split = megakernel.radiance_lanes_split(ts.data, ts.spec, *t_lanes, 5)
    for a, b in zip(got, split):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before


def test_split_path_is_for_large_scenes():
    ts = make_sphere_field(10, device="cpu")
    lanes = [torch.zeros(4, dtype=torch.int64)] * 4
    with pytest.raises(ValueError, match="more than 64 objects"):
        megakernel.radiance_lanes_split(ts.data, ts.spec, *lanes, 0)


def test_pack_scene_large_layout():
    """A large scene's buffer holds one 24-float row per object id, dead
    objects included, behind the header and the lights."""
    ts = make_sphere_field(100, device="cpu")
    spec = dataclasses.replace(
        ts.spec, shape_type=(-1,) + ts.spec.shape_type[1:])
    buf = megakernel.pack_scene(ts.data, spec)
    assert buf.shape == (24 + 24 * 106,)
    rows = buf[24:].reshape(106, 24)
    assert torch.equal(rows[:, 0:3], ts.data.prim_p)
    assert torch.equal(rows[:, 6:9], ts.data.mat_diffuse)
    assert rows[5, 21] == 1.0 and rows[4, 21] == 0.0
    assert not rows[:, 22:].any()


def test_image_loop_sizes_large_scenes_like_small_ones():
    """The kernels never widen the lane axis, so a large scene takes the
    same launches: 1,006 objects at 1024x1024 x 4 spp is one launch of
    4,194,304 lanes in one group."""
    spec = dataclasses.replace(
        make_sphere_field(10, mix_materials=False, device="cpu").spec,
        shape_type=(0,) * 1006, mat_type=(1,) * 1006)
    assert megakernel.is_large(spec)
    assert _s_p_launch(spec, 4, 1 << 22) == (4, 1024 * 1024)
    assert _group_cap(spec, 4) == 32


def test_render_image_large_scene_cpu():
    sc = make_sphere_field(200, width=8, height=8, antialias=1, device="cpu")
    img = render_image(sc, seed=3, spp=2)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.max() > 0


def test_cli_cpu_renders_large_scene(tmp_path):
    """A 70-object scene file through the CLI on the CPU at 16x16."""
    scene, out, log = (tmp_path / "field.txt", tmp_path / "field.bmp",
                       tmp_path / "log.jsonl")
    scene.write_text(sphere_field_source(64, mix_materials=False))
    r = subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.cli", str(scene), "-o",
         str(out), "--width", "16", "--height", "16", "--spp", "2",
         "--device", "cpu", "-q", "--log-json", str(log)],
        capture_output=True, text=True, timeout=300, cwd=str(REPO_ROOT))
    assert r.returncode == 0, r.stderr
    blob = out.read_bytes()
    assert blob[:2] == b"BM" and struct.unpack("<ii", blob[18:26]) == (16, 16)
    recs = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x for x in recs if x.get("event") == "scene"
            or x.get("objects")][0]["objects"] == 70
    done = [x for x in recs if "mean_radiance" in x][-1]
    assert done["nonfinite"] == 0 and done["mean_radiance"] > 0
    assert done["kernel_launches"] == 0 and done["primary_samples"] == 512


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [False, True])
def test_large_kernels_match_plain_version_on_card(cuda_device, mix):
    """The large instances of K1 (linear field) and K3 (mixed field)."""
    ts = make_sphere_field(300, mix_materials=mix, device=cuda_device)
    rs = np.random.RandomState(13)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 1024, 8192), rs.randint(0, 1024, 8192),
        rs.randint(0, 4, 8192), np.zeros(8192, np.int64))]
    kernel = megakernel.KERNEL_TREE if mix else megakernel.KERNEL_LINEAR
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(ts.data, ts.spec, *lanes, 13)
    want = megakernel.radiance_lanes_reference(ts.data, ts.spec, *lanes, 13)
    torch.cuda.synchronize()
    assert {k: megakernel.LAUNCHES[k] - before[k] for k in megakernel.KERNELS} \
        == {k: int(k == kernel) for k in megakernel.KERNELS}
    assert_radiance_close(torch.stack(list(got)).double().cpu().numpy(),
                          torch.stack(list(want)).double().cpu().numpy())
