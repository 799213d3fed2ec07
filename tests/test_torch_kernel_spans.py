"""What the render kernels' wrapper spans count: ``kernel_forward`` keeps
its counts with its span's record while a profiler records and keeps no
record otherwise (on the CPU, with a stand-in kernel); a render launch of
either kernel counts its lanes, whether it folds a large scene's table,
the scene's lights and the camera's lens samples, and a tree kernel's
launch also its stack instance (``megakernel.launch_counts``); on the
card each launch's span carries them."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.render import megakernel
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
    assert [r.counts for r in spans] == [want]
