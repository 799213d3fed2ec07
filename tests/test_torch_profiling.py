"""The profiler ranges of the render phases (``utils/profiling.py``) and
the CLI's ``--profile``, on the CPU: the ranges leave results unchanged,
a recording names raygen, intersect, shade, background, grad_psum and the
kernel wrapper's range, and ``--profile DIR`` writes a Chrome trace that
names them."""

import dataclasses
import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from raytrace_tpu_torch import optim
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.parallel.mesh import Mesh
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene.builder import load_scene_file
from raytrace_tpu_torch.utils import profiling

from conftest import repo_path
from test_torch_cli import _run

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
PHASES = {"raygen", "intersect", "shade", "background"}


def _ranges(prof) -> set:
    return {e.key for e in prof.key_averages()}


def test_annotate_names_the_phases_and_changes_nothing():
    sc = load_scene_file(SHOWCASE, device="cpu")
    rs = np.random.RandomState(2)
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in (
        rs.randint(0, 640, 64), rs.randint(0, 400, 64),
        rs.randint(0, 4, 64), rs.randint(0, 4, 64))]
    plain = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorded = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 2)
    assert PHASES <= _ranges(prof)
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b)
    # the wrapper returns the function's own result and keeps its name
    assert profiling.annotate("x")(lambda a, b=1: (a, b))(3, b=4) == (3, 4)
    assert megakernel.radiance_lanes_reference.__name__ \
        == "radiance_lanes_reference"
    from raytrace_tpu_torch.render.integrator import primary_rays
    assert primary_rays.__name__ == "primary_rays"


def test_kernel_range_and_grad_psum():
    """``kernel_forward`` records its kernel's name, forward and backward
    alike, and the sharded step's all-reduce records ``grad_psum`` (one
    rank on the CPU: the range with nothing in it)."""
    x = torch.linspace(0.0, 1.0, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, = kernel_forward(lambda t: (t * 2.0,), lambda t: (t * 2.0,), x,
                            name="megakernel_linear")
        y.sum().backward()
    assert "megakernel_linear" in _ranges(prof)
    assert torch.equal(x.grad, torch.full((8,), 2.0))
    sc = load_scene_file(CORNELL, device="cpu")
    spec = dataclasses.replace(sc.spec, width=4, height=4)
    pix = torch.arange(16)
    step = optim.make_sharded_step(spec, Mesh(torch.device("cpu")), 1)
    loss0, _ = optim.loss_and_grad(sc.data, spec, pix % 4, pix // 4,
                                   torch.arange(2), 1,
                                   torch.full((16, 3), 0.25))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = step(sc.data, pix % 4, pix // 4, torch.arange(2),
                       torch.full((16, 3), 0.25))
    assert (PHASES | {"grad_psum"}) <= _ranges(prof)
    assert float(loss) == float(loss0)


def test_cli_profile_writes_a_trace(tmp_path):
    """``--profile DIR`` on ``--device cpu``: the same BMP as without it,
    and a Chrome trace in DIR whose ranges name the render phases."""
    common = [CORNELL, "--width", "8", "--height", "8", "--spp", "2", "-q",
              "--device", "cpu"]
    r = _run([*common, "-o", str(tmp_path / "p.bmp"), "--profile",
              str(tmp_path / "trace")])
    assert r.returncode == 0, r.stderr
    plain = _run([*common, "-o", str(tmp_path / "x.bmp")])
    assert plain.returncode == 0, plain.stderr
    assert (tmp_path / "p.bmp").read_bytes() == (
        tmp_path / "x.bmp").read_bytes()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert PHASES <= names
