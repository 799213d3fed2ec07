"""Deep fan-out trees: every float32 tree goes through the tree kernel on a
CUDA tensor, whatever its DFS stack.  On the CPU: which stack instance a
tree takes (local memory up to 256 entries, the slab above), that no
float32 scene is refused, and that the CLI's ``--device cuda`` goes on to
render such a tree (the device check mocked).  On the card (the
``cuda``-marked tests): the deep instances, solid, under a skybox and in
a 1,006-object field, against the plain version to the bit, and the slab
form on trees a local stack would hold."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.scene import builder
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.procedural import sphere_field_source

from conftest import repo_path
from test_torch_kernel_work import INDIRECT

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))


def _deep(samples, max_depth, text=INDIRECT, device="cpu"):
    sc = builder.build_scene(tdsl.parse(text.replace("SAMPLES",
                                                     str(samples))),
                             device=device)
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, max_depth=max_depth))


@pytest.mark.parametrize("cap, inst", [(64, 64), (65, 128), (128, 128),
                                       (129, 256), (256, 256),
                                       (300, megakernel.TREE_SLAB)])
def test_deep_stacks_take_an_instance(cap, inst):
    """A tree whose plain walk needs ``cap`` entries takes the smallest
    local stack that holds them, the slab above 256; the kernels take it,
    float32, and only float64 is refused (item 12)."""
    assert megakernel.tree_instance(cap) == inst
    assert inst == megakernel.TREE_SLAB or inst >= cap
    ts = builder.load_scene_file(CORNELL, device="cpu")
    spec = dataclasses.replace(ts.spec, n_indirect=cap, max_depth=0)
    assert integrator.tree_loop_stack(spec)[3] == cap
    assert megakernel.kernel_for(spec) == megakernel.KERNEL_TREE
    assert megakernel.usable(ts.data, spec)
    assert megakernel.unsupported_reason(ts.data, spec) is None
    f64 = builder.load_scene_file(CORNELL, device="cpu",
                                  dtype=torch.float64)
    assert "ROADMAP item 12" in megakernel.unsupported_reason(
        f64.data, dataclasses.replace(f64.spec, n_indirect=cap, max_depth=0))


def test_cli_cuda_goes_on_to_render_a_deep_tree(tmp_path, monkeypatch):
    """``--device cuda`` renders a 16-sample IndirectPhong sphere at the
    fixed max_depth 4 (a stack of 76 entries), which it refused while the
    tree kernel held 64: with the device check mocked, the scene loaded
    on the CPU and the render stubbed, the CLI checks the scene, renders
    and writes its BMP."""
    from raytrace_tpu_torch import cli

    path = tmp_path / "deep.txt"
    path.write_text(INDIRECT.replace("SAMPLES", "16").replace(
        "width: 32 height: 32", "width: 4 height: 2"))
    real_load = builder.load_scene_file
    loaded, rendered = [], []

    def load(p, device, dtype):
        loaded.append(device)
        return real_load(p, device="cpu", dtype=dtype)

    def render(scene, **kw):
        rendered.append(integrator.tree_loop_stack(scene.spec)[3])
        return np.full((scene.spec.height, scene.spec.width, 3), 0.25)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "mock")
    monkeypatch.setattr(builder, "load_scene_file", load)
    monkeypatch.setattr(integrator, "render_image", render)
    out = tmp_path / "deep.bmp"
    assert cli.main([str(path), "-o", str(out), "--device", "cuda",
                     "-q"]) == 0
    assert [d.type for d in loaded] == ["cuda"] and rendered == [76]
    blob = out.read_bytes()
    assert blob[:2] == b"BM" and len(blob) == 122 + 12 * 2


# ---- on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _variant(samples, variant, device):
    """The deep scene at max_depth 0, solid, under a skybox of six faces
    made from a seed (written as BMPs beside the scene file), or the
    1,006-object field with every material at ``samples`` samples."""
    if variant == "field":
        text = sphere_field_source(1000, mix_materials=False).replace(
            "samples: 1", f"samples: {samples}")
        sc = builder.build_scene(tdsl.parse(text), device=device)
        return dataclasses.replace(sc, spec=dataclasses.replace(
            sc.spec, max_depth=0))
    sc = _deep(samples, 0, device=device)
    if variant == "sky":
        from raytrace_tpu_torch.scene.schema import BG_SKYBOX

        rs = np.random.RandomState(samples)
        cube = torch.from_numpy(rs.rand(6, 16, 16, 3).astype(np.float32))
        data = dataclasses.replace(sc.data, bg_cube=cube.to(device))
        spec = dataclasses.replace(sc.spec, bg_type=BG_SKYBOX,
                                   face_sizes=((16, 16),) * 6)
        sc = dataclasses.replace(sc, data=data, spec=spec)
    return sc


def _lanes(spec, n, seed, device):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
        rs.randint(0, max(spec.antialias, 1), n),
        rs.randint(0, spec.cam_samples, n))]


def _bit_equal(sc, lanes, seed):
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, seed)
    want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes,
                                               seed)
    torch.cuda.synchronize()
    assert {k: megakernel.LAUNCHES[k] - before[k] for k in megakernel.KERNELS
            } == {k: int(k == megakernel.KERNEL_TREE)
                  for k in megakernel.KERNELS}
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert float(want.x.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["solid", "sky", "field"])
@pytest.mark.parametrize("samples", [65, 129, 300])
def test_deep_instances_on_card(cuda_device, samples, variant):
    """The 128- and 256-entry stacks and the slab against the plain
    version, to the bit, on 2,048 random lanes."""
    sc = _variant(samples, variant, cuda_device)
    cap = integrator.tree_loop_stack(sc.spec)[3]
    assert megakernel.tree_instance(cap) == {
        65: 128, 129: 256, 300: megakernel.TREE_SLAB}[samples]
    _bit_equal(sc, _lanes(sc.spec, 2048, samples, cuda_device), samples)


@pytest.mark.cuda
@pytest.mark.parametrize("samples", [4, 65])
def test_slab_form_on_card(cuda_device, samples, monkeypatch):
    """The slab holds any stack: trees that take a local stack give the
    same bits through it."""
    sc = _deep(samples, 1 if samples == 4 else 0, device=cuda_device)
    monkeypatch.setattr(megakernel, "tree_instance",
                        lambda cap: megakernel.TREE_SLAB)
    _bit_equal(sc, _lanes(sc.spec, 4096, samples, cuda_device), samples)
