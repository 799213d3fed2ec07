"""Gradients of the PyTorch port: the render loss against central finite
differences and against the JAX package's gradients on the same scene,
finite gradients on fan-out and large scenes, the skybox texels' and the
scan's gradients, and inverse rendering (optim.fit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import optim as jax_optim
from raytrace_tpu.ops import intersect_pallas as jax_scan
from raytrace_tpu.ops.intersect import _packed_tables as jax_packed_tables
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import build_scene as jax_build
from raytrace_tpu.scene.schema import BG_SKYBOX as JAX_BG_SKYBOX
from raytrace_tpu_torch import optim
from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build, intersect_scan
from raytrace_tpu_torch.ops.intersect import _packed_tables, scene_tables
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.render.integrator import sample_pixels
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load
from raytrace_tpu_torch.scene.procedural import make_sphere_field
from raytrace_tpu_torch.scene.schema import BG_SKYBOX, SceneData

from conftest import repo_path
from test_grad import SCENE

SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
FIELDS = [f.name for f in dataclasses.fields(SceneData)]


def _setup(dtype=torch.float64, text=SCENE, max_depth=2):
    """The scene of tests/test_grad.py: a lit Phong sphere over a matte
    floor at 8x8, two samples per pixel, three shaded levels."""
    sc = torch_build(tdsl.parse(text), device="cpu", dtype=dtype)
    spec = dataclasses.replace(sc.spec, max_depth=max_depth)
    pix = torch.arange(spec.width * spec.height)
    px, py = pix % spec.width, pix // spec.width
    sids = torch.arange(2)
    target = torch.full((spec.width * spec.height, 3), 0.25, dtype=dtype)
    return sc.data, spec, px, py, sids, target


# leaf, index, whether the gradient must be nonzero
FD_CASES = {
    "sphere radius": ("prim_q", (1, 0), True),
    "sphere center": ("prim_p", (1, 2), False),
    "material diffuse": ("mat_diffuse", (1, 0), True),
    "light color": ("light_color", (0, 1), True),
    "light position": ("light_p", (0, 0), False),
    "camera position": ("cam_position", (1,), False),
    "plane normal": ("prim_q", (0, 1), False),
    "background": ("bg_color", (2,), True),
}


@pytest.mark.parametrize("case", list(FD_CASES))
def test_grad_matches_finite_differences(case):
    """Autograd of the render loss against a central difference on one
    scalar parameter, in float64, away from visibility silhouettes (the
    cases of tests/test_grad.py, with its eps and tolerance)."""
    leaf, idx, nonzero = FD_CASES[case]
    data, spec, px, py, sids, target = _setup()
    _, grads = optim.loss_and_grad(data, spec, px, py, sids, 0, target)
    g = float(getattr(grads, leaf)[idx])

    def loss_at(delta):
        moved = getattr(data, leaf).clone()
        moved[idx] += delta
        return float(optim.render_loss(
            dataclasses.replace(data, **{leaf: moved}), spec, px, py, sids, 0,
            target))

    eps = 1e-6
    fd = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=5e-4, atol=1e-8)
    assert g != 0.0 or not nonzero


def _jax_grads(text, max_depth, sky=None):
    js = jax_build(jdsl.parse(text), dtype=jnp.float64)
    spec = dataclasses.replace(js.spec, max_depth=max_depth)
    data = js.data
    if sky is not None:
        cube, sizes = sky
        data = dataclasses.replace(data, bg_cube=jnp.asarray(cube))
        spec = dataclasses.replace(spec, bg_type=JAX_BG_SKYBOX,
                                   face_sizes=sizes)
    w, h = spec.width, spec.height
    pix = np.arange(w * h, dtype=np.uint32)
    target = jnp.full((w * h, 3), 0.25, jnp.float64)
    return jax_optim.loss_and_grad(
        data, spec, jnp.asarray(pix % w), jnp.asarray(pix // w),
        jnp.arange(2, dtype=jnp.uint32), jnp.uint32(0), target)


def test_loss_and_grad_matches_jax():
    """Every float leaf's float64 gradient of the render loss equals the
    JAX package's on the same scene (which sums the same terms in its
    wavefront's order)."""
    data, spec, px, py, sids, target = _setup()
    loss, grads = optim.loss_and_grad(data, spec, px, py, sids, 0, target)
    want_loss, want = _jax_grads(SCENE, 2)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-12)
    moved = 0
    for n in FIELDS:
        g, w = getattr(grads, n).numpy(), np.asarray(getattr(want, n))
        assert g.shape == w.shape and np.isfinite(g).all(), n
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-9, err_msg=n)
        moved += bool(np.abs(g).max() > 0)
    assert moved >= 10


def test_skybox_texel_gradient_matches_jax():
    """A skybox scene: the cube takes a gradient through the four texel
    reads of every miss, equal to the JAX package's, as every other leaf's
    (bg_color takes none)."""
    sizes = ((3, 5), (4, 4), (2, 2), (4, 3), (3, 3), (5, 5))
    rs = np.random.RandomState(0)
    cube = np.zeros((6, 5, 5, 3))
    for i, (h, w) in enumerate(sizes):
        cube[i, :h, :w] = rs.rand(h, w, 3)
    data, spec, px, py, sids, target = _setup()
    data = dataclasses.replace(data, bg_cube=torch.tensor(cube))
    spec = dataclasses.replace(spec, bg_type=BG_SKYBOX, face_sizes=sizes)
    loss, grads = optim.loss_and_grad(data, spec, px, py, sids, 0, target)
    want_loss, want = _jax_grads(SCENE, 2, (cube, sizes))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-12)
    for n in FIELDS:
        np.testing.assert_allclose(getattr(grads, n).numpy(),
                                   np.asarray(getattr(want, n)), rtol=1e-6,
                                   atol=1e-9, err_msg=n)
    g = grads.bg_cube
    assert g.abs().max() > 0 and not grads.bg_color.any()
    for i, (h, w) in enumerate(sizes):      # the padding takes none
        assert not g[i, h:].any() and not g[i, :, w:].any()


def _finite_scene(case):
    if case == "showcase":
        sc = torch_load(SHOWCASE, device="cpu", dtype=torch.float64)
        return sc.data, dataclasses.replace(sc.spec, width=12, height=8,
                                            max_depth=3)
    sc = make_sphere_field(100, mix_materials=case == "mixed field",
                           width=12, height=12, device="cpu",
                           dtype=torch.float64)
    return sc.data, dataclasses.replace(sc.spec, max_depth=3)


@pytest.mark.parametrize("case", ["showcase", "linear field", "mixed field"])
def test_grads_finite_everywhere(case):
    """Fan-out with Fresnel, refraction and total internal reflection,
    area-light sampling and depth of field (the showcase), and the
    scanned regime of a 106-object field: no NaN or inf reaches a leaf
    through a branch not taken, and geometry, materials and camera move
    the loss."""
    data, spec = _finite_scene(case)
    pix = torch.arange(spec.width * spec.height)
    px, py = pix % spec.width, pix // spec.width
    target = torch.full((pix.shape[0], 3), 0.25, dtype=torch.float64)
    loss, grads = optim.loss_and_grad(data, spec, px, py, torch.arange(2), 3,
                                      target)
    assert torch.isfinite(loss)
    for n in FIELDS:
        assert torch.isfinite(getattr(grads, n)).all(), n
    for n in ("prim_p", "prim_q", "mat_diffuse", "mat_ambient",
              "cam_position", "cam_matrix"):
        assert getattr(grads, n).abs().max() > 0, n
    if case == "showcase":
        for n in ("mat_ior", "mat_specular", "mat_exponent", "light_p",
                  "light_e1", "light_color", "cam_focus", "cam_aperture"):
            assert getattr(grads, n).abs().max() > 0, n


def test_f32_cpu_gradient_goes_through_radiance_lanes():
    """In float32 on the CPU sample_pixels goes through radiance_lanes,
    which there is the plain version: same loss and gradients as the
    float64 path to float32 accuracy, and nothing launches."""
    d64, spec, px, py, sids, t64 = _setup()
    d32 = SceneData(**{n: getattr(d64, n).float() for n in FIELDS})
    before = dict(_build.LAUNCHES)
    l32, g32 = optim.loss_and_grad(d32, spec, px, py, sids, 0, t64.float())
    l64, g64 = optim.loss_and_grad(d64, spec, px, py, sids, 0, t64)
    assert _build.LAUNCHES == before
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-5)
    for n in ("mat_diffuse", "mat_ambient", "light_color", "bg_color"):
        np.testing.assert_allclose(getattr(g32, n).numpy(),
                                   getattr(g64, n).numpy(), rtol=1e-3,
                                   atol=1e-4, err_msg=n)


def test_loss_and_grad_trainable_mask():
    data, spec, px, py, sids, target = _setup()
    _, full = optim.loss_and_grad(data, spec, px, py, sids, 0, target)
    mask = SceneData(**{n: n == "mat_diffuse" for n in FIELDS})
    loss, grads = optim.loss_and_grad(data, spec, px, py, sids, 0, target,
                                      mask)
    assert not loss.requires_grad
    assert torch.equal(grads.mat_diffuse, full.mat_diffuse)
    for n in FIELDS:
        g = getattr(grads, n)
        assert g.shape == getattr(data, n).shape and not g.requires_grad
        assert n == "mat_diffuse" or not g.any(), n
    assert not any(getattr(data, n).requires_grad for n in FIELDS)


def _scan_rays(n, seed):
    r = np.random.RandomState(seed)
    ro = np.repeat([[0.0, 4.0, 28.0]], n, 0) + r.normal(0, 0.5, (n, 3))
    rd = r.normal(0, 1, (n, 3))
    return ro.astype(np.float32), rd.astype(np.float32)


def test_scan_hit_gradient_matches_jax():
    """d(sum of hit t)/d(table, rays) through scan_hit equals the JAX
    package's, whose custom VJP differentiates its jnp scan
    (tests/test_intersect_pallas.py:43)."""
    from raytrace_tpu.scene.procedural import make_sphere_field as jax_field

    js = jax_field(80, mix_materials=False)
    ts = make_sphere_field(80, mix_materials=False, device="cpu")
    ro, rd = _scan_rays(64, 3)
    jtable, n_sph_pad, jids = jax_packed_tables(js.data, js.spec)

    def jloss(table, o, d):
        t, _, hit = jax_scan._jnp_scan_reference(table, jids, n_sph_pad, o, d)
        return jnp.sum(jnp.where(hit, t, 0.0))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jtable, JV3(*jnp.asarray(ro).T), JV3(*jnp.asarray(rd).T))

    table, t_pad, ids = _packed_tables(ts.data, ts.spec)
    assert t_pad == n_sph_pad
    leaves = [table.clone().requires_grad_(True),
              *(torch.tensor(c).requires_grad_(True) for c in (*ro.T, *rd.T))]
    t, gid, hit = intersect_scan.scan_hit(leaves[0], ids, t_pad,
                                          V3(*leaves[1:4]), V3(*leaves[4:7]))
    assert t.requires_grad and not gid.requires_grad and hit.any()
    got = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), leaves)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], (*want[1], *want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    assert got[0].abs().max() > 0


def test_kernel_forward_contract():
    """The forward value is the kernel's, the gradient the plain
    version's; integer outputs take none; without grad it is one call."""
    calls = []

    def kernel(a, b):
        calls.append("kernel")
        return a * b + 100.0, (a > 0).to(torch.int32)

    def plain(a, b):
        calls.append("plain")
        return a * b, (a > 0).to(torch.int32)

    a = torch.tensor([1.0, -2.0, 3.0], requires_grad=True)
    b = torch.tensor([4.0, 5.0, 6.0])
    out, flag = kernel_forward(kernel, plain, a, b)
    assert calls == ["kernel"] and not flag.requires_grad
    assert out.tolist() == [104.0, 90.0, 118.0]
    (out * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    assert calls == ["kernel", "plain"]
    assert a.grad.tolist() == [4.0, 10.0, 18.0] and b.grad is None
    with torch.no_grad():
        kernel_forward(kernel, plain, a, b)
    kernel_forward(kernel, plain, a.detach(), b)
    assert calls == ["kernel", "plain", "kernel", "kernel"]


def _recovery_problem():
    data, spec, px, py, sids, _ = _setup()
    target = sample_pixels(data, spec, px, py, sids, 0)
    moved = data.mat_diffuse.clone()
    moved[1] = torch.tensor([0.3, 0.6, 0.6], dtype=torch.float64)
    mask = SceneData(**{n: n == "mat_diffuse" for n in FIELDS})
    return (data, dataclasses.replace(data, mat_diffuse=moved), spec, px, py,
            target, mask)


def test_fit_recovers_diffuse_color():
    """Inverse rendering: perturb the sphere's diffuse color and fit it
    back to the original from the original's render, with the settings of
    tests/test_grad.py (60 Adam steps at 5e-2, 2 samples per pixel)."""
    data, perturbed, spec, px, py, target, mask = _recovery_problem()
    seen = []
    fitted, hist = optim.fit(perturbed, spec, px, py, target, seed=0,
                             steps=60, learning_rate=5e-2, spp=2,
                             trainable=mask, vary_seed=False,
                             callback=lambda i, loss, d: seen.append(i))
    assert len(hist) == 60 and seen == list(range(60))
    assert hist[-1] < hist[0] * 1e-2
    np.testing.assert_allclose(fitted.mat_diffuse[1].numpy(),
                               data.mat_diffuse[1].numpy(), atol=0.03)
    # only the masked leaf moved, and the caller's tensors are untouched
    for n in FIELDS:
        assert n == "mat_diffuse" or torch.equal(getattr(fitted, n),
                                                 getattr(data, n)), n
    assert perturbed.mat_diffuse[1].tolist() == [0.3, 0.6, 0.6]


def test_fit_options():
    """vary_seed draws a new sample set each step; a custom optimizer is
    built from the trained tensors; by default every float leaf trains."""
    data, perturbed, spec, px, py, target, mask = _recovery_problem()
    _, fixed = optim.fit(perturbed, spec, px, py, target, steps=3, spp=2,
                         trainable=mask, vary_seed=False)
    _, varied = optim.fit(perturbed, spec, px, py, target, steps=3, spp=2,
                          trainable=mask, vary_seed=True)
    assert fixed[0] == varied[0] and fixed[1:] != varied[1:]
    built = []

    def sgd(params):
        built.append(params)
        return torch.optim.SGD(params, lr=1e-3)

    fitted, hist = optim.fit(perturbed, spec, px, py, target, steps=2, spp=2,
                             optimizer=sgd, vary_seed=False)
    assert len(built) == 1 and len(built[0]) == len(FIELDS)
    assert hist[1] < hist[0]
    assert not torch.equal(fitted.light_color, data.light_color)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_scene(case, device):
    if case == "large":
        sc = make_sphere_field(100, mix_materials=False, width=32, height=32,
                               device=device)
        return sc.data, dataclasses.replace(sc.spec, max_depth=2)
    if case == "tree":
        sc = torch_load(SHOWCASE, device=device)
        return sc.data, dataclasses.replace(sc.spec, width=32, height=32,
                                            max_depth=2)
    sc = torch_build(tdsl.parse(SCENE), device=device)
    return sc.data, dataclasses.replace(sc.spec, width=32, height=32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["linear", "tree", "large"])
def test_kernel_gradients_equal_plain_on_card(cuda_device, case):
    """Forward through the kernel, backward through the plain version:
    the gradient of sum(radiance) for every float leaf equals the plain
    path's alone (rtol 1e-5, atol 1e-6, tests/test_megakernel.py:137)."""
    data, spec = _card_scene(case, cuda_device)
    rs = np.random.RandomState(4)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 32, 2048), rs.randint(0, 32, 2048),
        rs.randint(0, 2, 2048), rs.randint(0, spec.cam_samples, 2048))]
    grads = []
    for fn in (megakernel.radiance_lanes, megakernel.radiance_lanes_reference):
        leaves = {n: getattr(data, n).clone().requires_grad_(True)
                  for n in FIELDS}
        before = sum(_build.LAUNCHES.values())
        out = fn(SceneData(**leaves), spec, *lanes, 4)
        assert (sum(_build.LAUNCHES.values()) - before
                == int(fn is megakernel.radiance_lanes))
        grads.append(torch.autograd.grad(
            out.x.sum() + out.y.sum() + out.z.sum(), list(leaves.values()),
            allow_unused=True))
    moved = 0
    for n, g, w in zip(FIELDS, *grads):
        assert (g is None) == (w is None), n
        if g is not None:
            assert torch.isfinite(g).all(), n
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6, msg=n)
            moved += bool(g.abs().max() > 0)
    assert moved >= 3


@pytest.mark.cuda
def test_float64_raises_on_card(cuda_device):
    """The kernels are float32: float64 on CUDA tensors raises and never
    takes the plain version there (on CPU tensors it does)."""
    sc = torch_build(tdsl.parse(SCENE), device=cuda_device,
                     dtype=torch.float64)
    spec = dataclasses.replace(sc.spec, width=8, height=8)
    pix = torch.arange(64, device=cuda_device)
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        sample_pixels(sc.data, spec, pix % 8, pix // 8, pix[:2], 0)
    sky = dataclasses.replace(spec, bg_type=BG_SKYBOX,
                              face_sizes=((2, 2),) * 6)
    data = dataclasses.replace(sc.data, bg_cube=torch.rand(
        (6, 2, 2, 3), dtype=torch.float64, device=cuda_device))
    with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
        backgrounds.background_color(data, sky, torch.rand(
            (16, 3), dtype=torch.float64, device=cuda_device))


@pytest.mark.cuda
def test_scan_and_skybox_kernel_gradients_on_card(cuda_device):
    sc = make_sphere_field(100, mix_materials=False, device=cuda_device)
    tb = scene_tables(sc.data, sc.spec)
    ro, rd = (torch.tensor(a, device=cuda_device) for a in _scan_rays(512, 5))
    grads = []
    for fn in (intersect_scan.scan_hit, intersect_scan.scan_hit_reference):
        leaves = [tb.table.clone().requires_grad_(True),
                  *(c.clone().requires_grad_(True) for c in (*ro.T, *rd.T))]
        t, _, hit = fn(leaves[0], tb.ids, tb.n_sph_pad, V3(*leaves[1:4]),
                       V3(*leaves[4:7]))
        grads.append(torch.autograd.grad(torch.where(hit, t, 0.0).sum(),
                                         leaves))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert grads[0][0].abs().max() > 0

    sizes = ((3, 5), (4, 4), (2, 2), (4, 3), (3, 3), (5, 5))
    spec = dataclasses.replace(sc.spec, bg_type=BG_SKYBOX, face_sizes=sizes)
    cube = torch.rand((6, 5, 5, 3), device=cuda_device, requires_grad=True)
    data = dataclasses.replace(sc.data, bg_cube=cube)
    dirs = rd.clone().requires_grad_(True)
    before = _build.LAUNCHES[_build.KERNEL_SKY]
    out = backgrounds.background_color(data, spec, dirs)
    assert _build.LAUNCHES[_build.KERNEL_SKY] == before + 1
    got = torch.autograd.grad(out.sum(), [cube, dirs])
    want = torch.autograd.grad(backgrounds._skybox(cube, spec, dirs).sum(),
                               [cube, dirs])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert got[0].abs().max() > 0
