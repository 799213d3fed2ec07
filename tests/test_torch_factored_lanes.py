"""A render launch's lanes in factored form (``megakernel.LaunchLanes``):
the (P,) pixels, the (S,) sample ids and the lens-sample count C, lane i
being pixel i // (S C), sample (i // C) % S and lens sample i % C.  On the
CPU: a mirror of the kernels' decode (``lane_id`` of
``csrc/render_common.cuh``) against ``lane_ids``' order, the factored
form against the four tensors to the bit, the fitting loss and gradient
of int32 and int64 ids against the four-tensor route of int64 ids, and the
plain path on int32 and int64 ids.  On the card (the ``cuda``-marked
tests): each instance of K1 and K3 on a factored launch against the same
lanes as four tensors, to the bit, and whole renders against the
four-tensor route."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import optim
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.render.megakernel import LaunchLanes
from raytrace_tpu_torch.scene.schema import SceneData

from test_torch_deep_tree import _deep
from test_torch_kernel_spans import _scene

# (pixels, sample ids) of a launch: P not a multiple of 32 with samples
# that do not start at 0, one sample, and a pixel list with repeats, as a
# mesh's padded shard has (pad pixels render pixel 0)
SHAPES = {"odd": (45, [5, 6, 7]), "one_sample": (38, [9]),
          "repeats": (37, [0, 1])}


def _pixels(spec, shape, device="cpu", dtype=torch.int64):
    n, sids = SHAPES[shape]
    if shape == "repeats":
        pix = torch.cat([torch.arange(n - 5),
                         torch.zeros(5, dtype=torch.int64)])
    else:
        pix = torch.from_numpy(np.random.RandomState(n).randint(
            0, spec.width * spec.height, n))
    return LaunchLanes((pix % spec.width).to(device, dtype),
                       (pix // spec.width).to(device, dtype),
                       torch.tensor(sids, dtype=dtype, device=device),
                       spec.cam_samples)


def _decode(i, samples, lens):
    """The kernels' decode of lane ``i`` (``lane_id``): its pixel, sample
    and lens sample, in 32-bit unsigned arithmetic."""
    q = i // lens
    p = q // samples
    return p, q - p * samples, i - q * lens


@pytest.mark.parametrize("p, s, c", [(1, 1, 1), (45, 3, 1), (7, 1, 4),
                                     (33, 3, 2), (5, 4, 4)])
def test_decode_matches_lane_ids(p, s, c):
    """Lane i of the decode is lane i of ``lane_ids``' expansion: pixel
    i // (S C), sample (i // C) % S, lens sample i % C."""
    rs = np.random.RandomState(p * 100 + s * 10 + c)
    px = torch.from_numpy(rs.randint(0, 800, p))
    py = torch.from_numpy(rs.randint(0, 800, p))
    sids = torch.arange(11, 11 + s)
    want = integrator.lane_ids(px, py, sids, c)
    i = torch.arange(p * s * c)
    pi, si, ci = _decode(i, s, c)
    assert torch.equal(pi, i // (s * c)) and torch.equal(si, (i // c) % s)
    assert torch.equal(ci, i % c)
    got = (px[pi], py[pi], sids[si], ci)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert LaunchLanes(px, py, sids, c).n == p * s * c


def test_launch_lanes_refuses_ragged_ids():
    px = torch.arange(4)
    with pytest.raises(ValueError):
        LaunchLanes(px, px[:3], torch.arange(2), 1)
    with pytest.raises(ValueError):
        LaunchLanes(px, px, torch.arange(4).reshape(2, 2), 1)
    with pytest.raises(ValueError):
        LaunchLanes(px, px, torch.arange(2), 0)
    with pytest.raises(TypeError):
        megakernel.lane_args((px, px, px, 0))


@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "showcase"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_factored_equals_four_tensors_on_cpu(case, shape):
    """On CPU tensors the factored form's radiance is the four tensors'
    to the bit, and so is the plain version's on either form."""
    sc = _scene(case)
    launch = _pixels(sc.spec, shape, dtype=torch.int32)
    got = megakernel.radiance_lanes(sc.data, sc.spec, launch, 7)
    want = megakernel.radiance_lanes(sc.data, sc.spec, *launch.expand(), 7)
    plain = megakernel.radiance_lanes_reference(sc.data, sc.spec, launch, 7)
    for g, w, r in zip(got, want, plain):
        assert g.shape == (launch.n,)
        assert torch.equal(g, w) and torch.equal(r, w)


@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "showcase"])
def test_int32_and_int64_ids_give_the_same_radiance(case):
    """The plain path reads int32 and int64 ids as the same words."""
    sc = _scene(case)
    lanes64 = _pixels(sc.spec, "odd").expand()
    got = megakernel.radiance_lanes_reference(
        sc.data, sc.spec, *(t.to(torch.int32) for t in lanes64), 3)
    want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes64, 3)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_id_dtype_guards_the_width():
    assert integrator.id_dtype(800 * 800) == torch.int32
    assert integrator.id_dtype(1 << 31) == torch.int32
    assert integrator.id_dtype((1 << 31) + 1) == torch.int64


def _four_tensor_route(monkeypatch):
    """``radiance_lanes`` as before the factored form: every launch's
    lanes expanded into four int64 tensors first."""
    real = megakernel.radiance_lanes

    def expanded(data, spec, *lanes):
        if isinstance(lanes[0], LaunchLanes):
            lanes = (*(t.to(torch.int64) for t in lanes[0].expand()),
                     lanes[1])
        return real(data, spec, *lanes)
    monkeypatch.setattr(megakernel, "radiance_lanes", expanded)


@pytest.mark.parametrize("case", ["cornell", "showcase"])
def test_fit_loss_and_gradient_are_the_four_tensor_routes(case,
                                                          monkeypatch):
    """With leaves that want a gradient, the loss and every gradient of
    int32 and of int64 ids are those of the four-tensor route on int64
    ids, to the bit."""
    sc = _scene(case)
    spec = dataclasses.replace(sc.spec, width=8, height=6, max_depth=2)
    pix = torch.arange(48)
    target = torch.rand((48, 3), generator=torch.Generator().manual_seed(1))
    runs = []
    for dtype in (torch.int32, torch.int64):
        runs.append(optim.loss_and_grad(
            sc.data, spec, (pix % 8).to(dtype), (pix // 8).to(dtype),
            torch.arange(2, dtype=dtype), 5, target))
    _four_tensor_route(monkeypatch)
    runs.append(optim.loss_and_grad(sc.data, spec, pix % 8, pix // 8,
                                    torch.arange(2), 5, target))
    (l32, g32), (l64, g64), (want, gw) = runs
    assert torch.equal(l32, want) and torch.equal(l64, want)
    for f in dataclasses.fields(SceneData):
        w = getattr(gw, f.name)
        assert torch.equal(getattr(g32, f.name), w), f.name
        assert torch.equal(getattr(g64, f.name), w), f.name


@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "showcase"])
def test_smoke_cli_launch_is_pixel_lanes_factored(case):
    """``chip_smoke.cli_launch_lanes``, the launch the card's smoke holds
    the kernels to, is the CLI's first launch in factored form: expanded,
    the lanes of ``chip_smoke.pixel_lanes``; its every 8th pixel keeps
    every sample of those pixels."""
    from chip_smoke import cli_launch_lanes, pixel_lanes

    sc = _scene(case)
    spec = dataclasses.replace(sc.spec, width=12, height=7)
    launch, s_launch = cli_launch_lanes(spec, "cpu")
    assert launch.px.dtype == launch.sample_ids.dtype == torch.int32
    assert s_launch == launch.sample_ids.shape[0] == min(
        spec.antialias, (1 << 22) // (84 * spec.cam_samples))
    want = pixel_lanes(12, 84, s_launch, spec.cam_samples, "cpu")
    for got, w in zip(launch.expand(), want):
        assert torch.equal(got.to(torch.int64), w)
    eighth, _ = cli_launch_lanes(spec, "cpu", every=8)
    assert torch.equal(eighth.px.to(torch.int64), want[0].reshape(84, -1)[
        ::8, 0])
    assert eighth.n == 11 * s_launch * spec.cam_samples


# ---- on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _instance(case, device):
    """K1 plain (cornell), K1 lit with the DoF camera (the lit mirror, 2
    lens samples), K1 large (the 1,006-object field), K3 small (the
    showcase, 4 lens samples), K3 large (the mixed field) and K3's slab
    instance (a 300-sample IndirectPhong sphere at max_depth 0)."""
    if case == "slab":
        sc = _deep(300, 0, device=device)
        assert megakernel.tree_instance(
            integrator.tree_loop_stack(sc.spec)[3]) == megakernel.TREE_SLAB
        return sc
    return _scene(case, device)


INSTANCES = ["cornell", "lit_mirror", "field", "showcase", "mix", "slab"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", INSTANCES)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_factored_launch_equals_four_tensor_launch(cuda_device, case,
                                                   shape):
    """Each instance's factored launch gives, lane by lane, the radiance
    of one launch of the four tensors of ``lane_ids``' expansion of the
    same pixels, sample ids and lens samples, to the bit; int32 and int64
    factored ids alike."""
    sc = _instance(case, cuda_device)
    name = megakernel.kernel_for(sc.spec)
    launch = _pixels(sc.spec, shape, cuda_device)
    want = megakernel.radiance_lanes(sc.data, sc.spec, *launch.expand(), 11)
    for dtype in (torch.int32, torch.int64):
        ids = LaunchLanes(launch.px.to(dtype), launch.py.to(dtype),
                          launch.sample_ids.to(dtype), launch.cam_samples)
        before = megakernel.LAUNCHES[name]
        got = megakernel.radiance_lanes(sc.data, sc.spec, ids, 11)
        torch.cuda.synchronize()
        assert megakernel.LAUNCHES[name] == before + 1
        for g, w in zip(got, want):
            assert g.shape == (launch.n,)
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cornell", "lit_mirror", "showcase"])
def test_render_equals_four_tensor_route(cuda_device, case, monkeypatch):
    """A whole ``render_image`` on factored launches (two launch groups of
    a sample each launch, the last tile of pixels short) gives the image
    of the route that expands every launch into four int64 tensors, to the
    bit."""
    sc = _scene(case, cuda_device)
    sc = dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=40, height=23))
    kw = dict(seed=4, spp=40, max_lanes=512)
    got = integrator.render_image(sc, **kw)
    _four_tensor_route(monkeypatch)
    want = integrator.render_image(sc, **kw)
    assert np.array_equal(got, want)
