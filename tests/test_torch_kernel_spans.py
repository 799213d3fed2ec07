"""What the render kernels' wrapper spans count: ``kernel_forward`` keeps
its counts with its span's record while a profiler records and keeps no
record otherwise (on the CPU, with a stand-in kernel); a render launch of
either kernel counts its lanes, whether it folds a large scene's table,
the scene's lights and the camera's lens samples, and a tree kernel's
launch also its stack instance (``megakernel.launch_counts``), and
whether the kernel decoded the launch's lanes from their factored form
(``factored``); on the card each launch's span carries them: 1 on the
image loop's launches, 0 on four lane tensors and where a gradient is
wanted."""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.render.megakernel import LaunchLanes
from raytrace_tpu_torch.scene import dsl, procedural
from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file
from raytrace_tpu_torch.utils import profiling

from conftest import repo_path

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
COUNTS = {"lanes": 6, "stack": 8, "large": 1}
LINEAR_COUNTS = {"lanes": 6, "large": 0, "lights": 2, "lens": 2}
# a Phong mirror floor and a Phong sphere under a point and a directional
# light, seen through a depth-of-field camera of 2 lens samples: linear
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


def _twice(t):
    return (t * 2.0,)


def _keeps_its_counts(name, counts):
    x = torch.arange(6.0)
    before = len(profiling.recorded())
    out, = kernel_forward(_twice, _twice, x, name=name, **counts)
    assert torch.equal(out, x * 2.0)
    assert len(profiling.recorded()) == before
    with profile(activities=[ProfilerActivity.CPU]):
        out, = kernel_forward(_twice, _twice, x, name=name, **counts)
    new = profiling.recorded()[before:]
    assert [(r.name, r.counts) for r in new] == [(name, counts)]
    assert new[0].end_ns is not None and torch.equal(out, x * 2.0)


def test_kernel_forward_keeps_its_counts_while_recording():
    _keeps_its_counts("megakernel_tree", COUNTS)


def test_kernel_forward_keeps_a_linear_launchs_counts():
    """A K1 launch's span keeps its instance's counts as a tree one's."""
    _keeps_its_counts("megakernel_linear", LINEAR_COUNTS)


def _field(mix: bool, device="cpu"):
    return build_scene(dsl.parse(procedural.sphere_field_source(
        1000, mix_materials=mix)), device=device)


@pytest.mark.parametrize("case, want", [
    ("cornell", {"lanes": 96, "large": 0, "lights": 0, "lens": 1}),
    ("field", {"lanes": 96, "large": 1, "lights": 0, "lens": 1}),
    ("lit_mirror", {"lanes": 96, "large": 0, "lights": 2, "lens": 2}),
    ("showcase", {"lanes": 96, "stack": 8, "large": 0, "lights": 3,
                  "lens": 4}),
    ("mix", {"lanes": 96, "stack": 8, "large": 1, "lights": 0, "lens": 1}),
])
def test_launch_counts(case, want):
    """Every launch counts its lanes, ``large``, the scene's lights and the
    camera's lens samples; K3's also the stack instance of a 6-level
    binary tree (6 entries: the 8-entry instance)."""
    assert megakernel.launch_counts(_scene(case).spec, 96) == want


def test_tree_counts_name_the_lit_instance():
    """A tree launch's counts tell the showcase's instance (three lights,
    four lens samples, the small scene) from the mixed field's (no light,
    a pinhole camera, the fold), and a linear launch's tell the lit
    mirror's instance (two lights, two lens samples) from the cornell
    box's (no light, a pinhole camera) by the same keys, without a
    stack."""
    lit, mix = (megakernel.launch_counts(_scene(c).spec, 96)
                for c in ("showcase", "mix"))
    assert {k for k in lit if lit[k] != mix[k]} == {"large", "lights",
                                                    "lens"}
    mirror, cornell = (megakernel.launch_counts(_scene(c).spec, 96)
                       for c in ("lit_mirror", "cornell"))
    assert set(mirror) == set(cornell) == {"lanes", "large", "lights",
                                           "lens"}
    assert {k for k in mirror if mirror[k] != cornell[k]} == {"lights",
                                                              "lens"}


def _scene(case, device="cpu"):
    return {"cornell": lambda: load_scene_file(CORNELL, device=device),
            "showcase": lambda: load_scene_file(SHOWCASE, device=device),
            "lit_mirror": lambda: build_scene(dsl.parse(LIT_MIRROR),
                                              device=device),
            "field": lambda: _field(False, device),
            "mix": lambda: _field(True, device)}[case]()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "mix",
                                  "showcase"])
def test_render_launch_records_its_counts(cuda_device, case):
    """One launch of K1 (cornell), of its lit instance (the lit mirror), of
    K3's large instance (the mixed 1,006-object field) or of its small one
    (the showcase) under the profiler: one wrapper span, counting the
    launch's lanes, ``large``, the lights and the lens samples, and for K3
    the 8-entry stack."""
    sc = _scene(case, cuda_device)
    rs = np.random.RandomState(4)
    n = 8192
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, sc.spec.width, n), rs.randint(0, sc.spec.height, n),
        rs.randint(0, 16, n), np.zeros(n))]
    megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 3)   # builds
    before = len(profiling.recorded())
    with profile(activities=profiling.trace_activities(cuda_device)):
        megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 3)
        torch.cuda.synchronize()
    name = megakernel.kernel_for(sc.spec)
    spans = [r for r in profiling.recorded()[before:] if r.name == name]
    tree = {"lanes": n, "stack": 8}
    want = {"cornell": {"lanes": n, "large": 0, "lights": 0, "lens": 1},
            "lit_mirror": {"lanes": n, "large": 0, "lights": 2, "lens": 2},
            "mix": dict(tree, large=1, lights=0, lens=1),
            "showcase": dict(tree, large=0, lights=3, lens=4)}[case]
    assert [r.counts for r in spans] == [dict(want, factored=0)]


def _recorded_launches(name, fn):
    before = len(profiling.recorded())
    with profile(activities=profiling.trace_activities(
            torch.device("cuda", 0))):
        out = fn()
        torch.cuda.synchronize()
    return out, [r for r in profiling.recorded()[before:] if r.name == name]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "mix",
                                  "showcase"])
def test_image_loop_launches_count_factored(cuda_device, case):
    """Every launch of a render counts ``factored`` 1, its lanes the
    launch's pixels x samples x lens samples (all the render's lanes
    together) and its instance as a four-tensor launch of the scene
    counts it."""
    sc = _scene(case, cuda_device)
    sc = dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=24, height=10))
    name = megakernel.kernel_for(sc.spec)
    integrator.render_image(sc, seed=1, spp=4, max_lanes=256)   # builds
    before = megakernel.LAUNCHES[name]
    _, spans = _recorded_launches(name, lambda: integrator.render_image(
        sc, seed=1, spp=4, max_lanes=256))
    assert len(spans) == megakernel.LAUNCHES[name] - before > 1
    assert {r.counts["factored"] for r in spans} == {1}
    assert sum(r.counts["lanes"] for r in spans) == 240 * 4 * (
        sc.spec.cam_samples)
    for r in spans:
        assert r.counts == dict(megakernel.launch_counts(
            sc.spec, r.counts["lanes"]), factored=1)


@pytest.mark.cuda
def test_launch_that_wants_a_gradient_reads_four_tensors(cuda_device):
    """A factored launch whose scene has a leaf that wants a gradient
    takes the four tensors (its backward runs the plain version on them):
    its span counts ``factored`` 0, and its radiance and gradient are the
    four tensors' own."""
    sc = _scene("lit_mirror", cuda_device)
    pix = torch.arange(300, device=cuda_device)
    launch = LaunchLanes(pix % 32, pix // 32,
                         torch.arange(2, device=cuda_device), 2)
    grads = []
    for lanes in ((launch,), launch.expand()):
        color = sc.data.bg_color.clone().requires_grad_(True)
        data = dataclasses.replace(sc.data, bg_color=color)
        out, spans = _recorded_launches(
            "megakernel_linear",
            lambda: megakernel.radiance_lanes(data, sc.spec, *lanes, 2))
        assert [r.counts["factored"] for r in spans] == [0]
        grads.append((torch.stack(list(out)), torch.autograd.grad(
            out.x.sum() + out.y.sum() + out.z.sum(), color)[0]))
    (r0, g0), (r1, g1) = grads
    assert torch.equal(r0, r1) and torch.equal(g0, g1)
