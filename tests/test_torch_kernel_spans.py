"""What the render kernels' wrapper spans count: ``kernel_forward`` keeps
its counts with its span's record while a profiler records and keeps no
record otherwise (on the CPU, with a stand-in kernel); a render launch
counts its lanes, and a tree kernel's launch also its stack instance and
whether it folds a large scene's table (``megakernel.launch_counts``); on
the card each launch's span carries them."""

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


def _twice(t):
    return (t * 2.0,)


def test_kernel_forward_keeps_its_counts_while_recording():
    x = torch.arange(6.0)
    before = len(profiling.recorded())
    out, = kernel_forward(_twice, _twice, x, name="megakernel_tree",
                          **COUNTS)
    assert torch.equal(out, x * 2.0)
    assert len(profiling.recorded()) == before
    with profile(activities=[ProfilerActivity.CPU]):
        out, = kernel_forward(_twice, _twice, x, name="megakernel_tree",
                              **COUNTS)
    new = profiling.recorded()[before:]
    assert [(r.name, r.counts) for r in new] == [("megakernel_tree",
                                                  COUNTS)]
    assert new[0].end_ns is not None and torch.equal(out, x * 2.0)


def _field(mix: bool, device="cpu"):
    return build_scene(dsl.parse(procedural.sphere_field_source(
        1000, mix_materials=mix)), device=device)


@pytest.mark.parametrize("case, want", [
    ("cornell", {"lanes": 96}),
    ("field", {"lanes": 96}),
    ("showcase", {"lanes": 96, "stack": 8, "large": 0}),
    ("mix", {"lanes": 96, "stack": 8, "large": 1}),
])
def test_launch_counts(case, want):
    """K1's launches count their lanes; K3's also the stack instance of a
    6-level binary tree (6 entries: the 8-entry instance) and ``large``."""
    spec = {"cornell": lambda: load_scene_file(CORNELL, device="cpu"),
            "showcase": lambda: load_scene_file(SHOWCASE, device="cpu"),
            "field": lambda: _field(False),
            "mix": lambda: _field(True)}[case]().spec
    assert megakernel.launch_counts(spec, 96) == want


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell", "mix"])
def test_render_launch_records_its_counts(cuda_device, case):
    """One launch of K1 (cornell) or of K3's large instance (the mixed
    1,006-object field) under the profiler: one wrapper span, counting the
    launch's lanes, and for K3 the 8-entry stack and ``large``."""
    sc = (load_scene_file(CORNELL, device=cuda_device) if case == "cornell"
          else _field(True, cuda_device))
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
    want = ({"lanes": n} if case == "cornell"
            else {"lanes": n, "stack": 8, "large": 1})
    assert [r.counts for r in spans] == [want]
