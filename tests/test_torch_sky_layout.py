"""The skybox faces as the CUDA lookup reads them: the packed form that
``models/backgrounds.py::pack_sky`` makes of the cube, its cache, the
checks of the wrapper, and a numpy model of the lookup of
``csrc/render_common.cuh`` (``sky_lookup``) reading the packed form,
held to the plain version ``_skybox`` bit for bit.  The tests marked
``cuda`` hold ``csrc/skybox.cu`` and the sky instances of both render
kernels to the plain version on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.scene.schema import BG_SKYBOX, SceneSpec

# faces of two sizes, the smaller one (ny) inside the others' padding, as
# in chip_smoke.py's cube; and six faces of six sizes
TWO_SIZES = ((4, 6), (4, 6), (4, 6), (2, 3), (4, 6), (4, 6))
SIX_SIZES = ((3, 5), (4, 4), (2, 2), (4, 3), (3, 3), (5, 5))
F32 = np.float32


def _cube(sizes, seed, pad=np.nan):
    """A float32 cube whose padding holds ``pad``."""
    rs = np.random.RandomState(seed)
    cube = np.full((6, max(h for h, _ in sizes), max(w for _, w in sizes), 3),
                   pad, np.float32)
    for i, (h, w) in enumerate(sizes):
        cube[i, :h, :w] = rs.rand(h, w, 3)
    return cube


def _spec(sizes):
    return SceneSpec(bg_type=BG_SKYBOX, shape_type=(0,), mat_type=(0,),
                     light_type=(), face_sizes=sizes)


def _directions(n, seed):
    """Seeded float32 directions: random ones, exact ties for the largest
    component, axis-aligned ones, zero components, and on every face the
    ratios that put u or v on a face's edge (u = 1 exactly, u next to 0)
    and at its centre."""
    rs = np.random.RandomState(seed)
    rd = rs.normal(size=(n, 3)).astype(F32)
    rd[:100, 0] = rd[:100, 1]                  # |dx| == |dy|, the largest
    rd[:100, 2] = F32(0.3) * rd[:100, 1]
    rd[100:200, 1] = -rd[100:200, 2]           # |dy| == |dz|, the largest
    rd[100:200, 0] = F32(0.3) * rd[100:200, 2]
    rd[200:300, 2] = 0.0
    rd[300:400, (0, 1)] = 0.0                  # along z
    rd[400:412] = np.repeat(np.concatenate([np.eye(3), -np.eye(3)]), 2, 0)
    rd[412:420] = 0.0
    rd[420:430] = 1.0                          # a three-way tie
    # on each face (dominant axis a, sign s), both other components at the
    # ratios +-(1 - 2**-24), +-2**-24 and 0 of the dominant one
    edge = F32(1.0) - F32(2.0 ** -24)
    ratios = np.array([edge, -edge, F32(2.0 ** -24), -F32(2.0 ** -24), 0.0],
                      F32)
    rows = []
    for a in range(3):
        for s in (F32(1.0), F32(-1.0)):
            for p in ratios:
                for q in ratios:
                    d = np.zeros(3, F32)
                    d[a] = s
                    d[(a + 1) % 3], d[(a + 2) % 3] = p, q
                    rows.append(d)
    rows = np.stack(rows)
    rd[1000:1000 + len(rows)] = rows
    return rd


def lookup_model(packed, face_sizes, rd):
    """csrc/render_common.cuh::sky_lookup in numpy float32, reading the
    packed faces: the radiance (N, 3) and the (face, y, x) entry each
    lookup read (-1 where a tie leaves it black)."""
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ax, ay, az = np.abs(dx), np.abs(dy), np.abs(dz)
    xd = (ax > az) & (ax > ay)
    yd = ~xd & (ay > ax) & (ay > az)
    zd = ~xd & ~yd & (az > ax) & (az > ay)
    dom = xd | yd | zd
    face = np.where(xd, np.where(dx > 0, 0, 1),
                    np.where(yd, np.where(dy > 0, 2, 3),
                             np.where(dz > 0, 4, 5)))
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.where(xd, -dz / dx, np.where(yd, dx / ay, dx / dz))
        v = np.where(xd, -dy / ax, np.where(yd, dz / dy, -dy / az))
    u = np.where(dom, u, F32(0.0)) * F32(0.5) + F32(0.5)
    v = np.where(dom, v, F32(0.0)) * F32(0.5) + F32(0.5)
    sizes = np.asarray(face_sizes)
    fh = sizes[face, 0].astype(F32)
    fw = sizes[face, 1].astype(F32)
    x = np.minimum(np.maximum(u, F32(0.0)), F32(1.0)) * (fw - F32(1.0))
    y = np.minimum(np.maximum(v, F32(0.0)), F32(1.0)) * (fh - F32(1.0))
    x0, y0 = np.floor(x), np.floor(y)
    xx, yy = x - x0, y - y0
    omx, omy = F32(1.0) - xx, F32(1.0) - yy
    x0i, y0i = x0.astype(np.int64), y0.astype(np.int64)
    q = packed[face, y0i, x0i]                       # (N, 16)
    c00, c01, c10, c11 = q[:, 0:3], q[:, 3:6], q[:, 6:9], q[:, 9:12]
    cx0 = c00 * omy[:, None] + c01 * yy[:, None]
    cx1 = c10 * omy[:, None] + c11 * yy[:, None]
    out = cx0 * omx[:, None] + cx1 * xx[:, None]
    out = np.where(dom[:, None], out, F32(0.0))
    read = np.stack([np.where(dom, face, -1), np.where(dom, y0i, -1),
                     np.where(dom, x0i, -1)], 1)
    return out.astype(F32), read


@pytest.mark.parametrize("sizes", [TWO_SIZES, SIX_SIZES],
                         ids=["two sizes", "six sizes"])
def test_pack_sky_holds_the_texels_the_lookup_reads(sizes):
    """Entry (f, y, x) of the packed form holds texels (y, x), (y1, x),
    (y, x1), (y1, x1) of face f, clamped at the face's own size, then four
    zeros; the cube's padding (NaN here) reaches no entry, the packed
    padding is 0."""
    cube = _cube(sizes, 0)
    packed = backgrounds.pack_sky(torch.from_numpy(cube), sizes).numpy()
    hmax, wmax = cube.shape[1:3]
    assert packed.shape == (6, hmax, wmax, 16) and packed.dtype == F32
    assert not packed[..., 12:].any()
    for f, (h, w) in enumerate(sizes):
        for y in range(hmax):
            for x in range(wmax):
                got = packed[f, y, x, :12].reshape(4, 3)
                if y >= h or x >= w:
                    assert not got.any()
                    continue
                y1, x1 = min(y + 1, h - 1), min(x + 1, w - 1)
                want = cube[f, [y, y1, y, y1], [x, x, x1, x1]]
                assert np.array_equal(got, want)
    assert np.isfinite(packed).all()


@pytest.mark.parametrize("sizes", [TWO_SIZES, SIX_SIZES],
                         ids=["two sizes", "six sizes"])
def test_lookup_model_on_packed_faces_equals_skybox_to_the_bit(sizes):
    """The numpy model of sky_lookup, reading the packed faces, equals
    _skybox on the cube bit for bit; ties are black; it reads entries
    inside a face's own size only, the smaller faces' last row and column
    and u = 1 exactly among them."""
    cube = _cube(sizes, 1)
    rd = _directions(20000, 2)
    packed = backgrounds.pack_sky(torch.from_numpy(cube), sizes).numpy()
    got, read = lookup_model(packed, sizes, rd)
    want = backgrounds._skybox(torch.from_numpy(np.nan_to_num(cube)),
                               _spec(sizes), torch.from_numpy(rd)).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got[:200].any() and not got[420:430].any()
    dom = read[:, 0] >= 0
    sizes_a = np.asarray(sizes)
    h, w = sizes_a[read[dom, 0], 0], sizes_a[read[dom, 0], 1]
    assert (read[dom, 1] < h).all() and (read[dom, 2] < w).all()
    # every face's edges were read: its last column (u = 1) and row
    for f, (fh, fw) in enumerate(sizes):
        on = read[:, 0] == f
        assert (read[on, 2] == fw - 1).any() and (read[on, 1] == fh - 1).any()
        assert (read[on, 2] == 0).any() and (read[on, 1] == 0).any()


def test_cached_pack_sky_follows_the_cube():
    """The same unmodified cube gives back the same packed tensor; a
    change in place (as a fitting step makes), another cube or other face
    sizes pack anew."""
    cube = torch.from_numpy(_cube(TWO_SIZES, 3, pad=0.0))
    first = backgrounds.cached_pack_sky(cube, TWO_SIZES)
    assert backgrounds.cached_pack_sky(cube, TWO_SIZES) is first
    cube[3, 1, 2] += 1.0
    changed = backgrounds.cached_pack_sky(cube, TWO_SIZES)
    assert changed is not first
    assert torch.equal(changed, backgrounds.pack_sky(cube, TWO_SIZES))
    assert not torch.equal(changed, first)
    assert backgrounds.cached_pack_sky(cube, TWO_SIZES) is changed
    other = cube.clone()
    again = backgrounds.cached_pack_sky(other, TWO_SIZES)
    assert again is not changed and torch.equal(again, changed)
    smaller = tuple((h, w - 1) for h, w in TWO_SIZES)
    assert not torch.equal(backgrounds.cached_pack_sky(other, smaller), again)


@pytest.mark.parametrize("case", ["cpu", "float64", "four channels",
                                  "beyond 32-bit indexing", "five faces"])
def test_sky_buffer_refuses_what_the_lookup_cannot_read(case):
    """The packed form's wrapper raises on a cube the CUDA lookup cannot
    read: not a CUDA tensor, not float32, not (6, H, W, 3), or a packed
    form beyond the lookup's 32-bit index (a
    meta tensor of that shape: nothing is allocated)."""
    spec = _spec(TWO_SIZES)
    shape, kw = (6, 4, 6, 3), dict(device="meta", dtype=torch.float32)
    if case == "cpu":
        cube = torch.zeros(shape)
    elif case == "float64":
        cube = torch.empty(shape, device="meta", dtype=torch.float64)
    elif case == "four channels":
        cube = torch.empty((6, 4, 6, 4), **kw)
    elif case == "beyond 32-bit indexing":
        cube = torch.empty((6, 8192, 8192, 3), **kw)
    else:
        cube = torch.empty((5, 4, 6, 3), **kw)
    match = "32-bit" if case == "beyond 32-bit indexing" else "CUDA tensor"
    with pytest.raises(ValueError, match=match):
        backgrounds.sky_buffer(cube, spec)


# ---- on the card -----------------------------------------------------------

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# a Phong floor and a sphere under the open sky: Phong (one reflect slot,
# the linear kernel) or Transparent (two slots, the tree kernel)
SKY_SCENE = """{ objects: [
  { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
    material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
      specular: rgb(0.3,0.3,0.3) exponent: 8 ambient: rgb(0.05,0.05,0.05) } }
  { bounds: Sphere { center: (0, 0, -4) radius: 1 } material: MATERIAL } ]
  lights: []
  camera: SimplePerspectiveCamera new((0, 0.5, 2), (0, -0.1, -1), (0, 1, 0),
                                      2.0)
  background: SolidColorBackground { color: rgb(0, 0, 0) }
  options: { width: 128 height: 128 antialias: 4 } }"""
MATERIALS = {
    _build.KERNEL_LINEAR: "PhongMaterial { diffuse: rgb(0.8,0.3,0.2) "
                          "specular: rgb(0.4,0.4,0.4) exponent: 16 "
                          "ambient: rgb(0,0,0) }",
    _build.KERNEL_TREE: "TransparentMaterial { specular: rgb(0.9,0.9,0.9) "
                        "exponent: 8 ior: 1.5 }"}


def _sky_scene(device, kernel=_build.KERNEL_LINEAR):
    """SKY_SCENE for ``kernel`` under a sky of TWO_SIZES faces."""
    sc = build_scene(dsl.parse(SKY_SCENE.replace("MATERIAL",
                                                 MATERIALS[kernel])),
                     device=device)
    spec = dataclasses.replace(sc.spec, bg_type=BG_SKYBOX,
                               face_sizes=TWO_SIZES, max_depth=3)
    data = dataclasses.replace(sc.data, bg_cube=torch.from_numpy(
        _cube(TWO_SIZES, 4, pad=0.0)).to(device))
    assert megakernel.kernel_for(spec) == kernel
    return data, spec


def _coherent_directions(device, n=1 << 18):
    """Camera-like directions in pixel order: a 512 x 512 grid toward -z."""
    side = int(round(n ** 0.5))
    y, x = torch.meshgrid(torch.linspace(1, -1, side, device=device),
                          torch.linspace(-1, 1, side, device=device),
                          indexing="ij")
    rd = torch.stack([x, y, -torch.ones_like(x) * 0.8], -1).reshape(-1, 3)
    return (rd / rd.norm(dim=1, keepdim=True)).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["random", "coherent"])
def test_skybox_kernel_on_random_and_coherent_directions(cuda_device, which):
    """csrc/skybox.cu against _skybox: equal to the bit wherever the two
    divide alike, and within 1e-6 on at least 99.9% of the directions."""
    spec = _spec(TWO_SIZES)
    cube = torch.from_numpy(_cube(TWO_SIZES, 5, pad=0.0)).to(cuda_device)
    data = dataclasses.replace(_sky_scene(cuda_device)[0], bg_cube=cube)
    rd = (torch.from_numpy(_directions(1 << 18, 6)).to(cuda_device)
          if which == "random" else _coherent_directions(cuda_device))
    before = _build.LAUNCHES[_build.KERNEL_SKY]
    got = backgrounds.background_color(data, spec, rd)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[_build.KERNEL_SKY] == before + 1
    want = backgrounds._skybox(cube, spec, rd)
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-6).all(dim=1).float().mean() >= 0.999
    assert (got == want).all(dim=1).float().mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [_build.KERNEL_LINEAR, _build.KERNEL_TREE])
def test_sky_instances_on_pixel_ordered_lanes(cuda_device, kernel):
    """The sky instances against the plain path on pixel-ordered lanes,
    whose misses are neighbours on a face, and on random lanes; the tree
    kernel bit for bit."""
    data, spec = _sky_scene(cuda_device, kernel)
    n_pix = spec.width * spec.height
    pix = torch.arange(n_pix, device=cuda_device).repeat_interleave(4)
    rs = np.random.RandomState(9)
    for lanes in ([pix % spec.width, pix // spec.width,
                   torch.arange(4, device=cuda_device).repeat(n_pix),
                   torch.zeros_like(pix)],
                  [torch.from_numpy(a).to(cuda_device) for a in (
                      rs.randint(0, spec.width, 4 * n_pix),
                      rs.randint(0, spec.height, 4 * n_pix),
                      rs.randint(0, 4, 4 * n_pix),
                      np.zeros(4 * n_pix, np.int64))]):
        before = _build.LAUNCHES[kernel]
        got = torch.stack(list(megakernel.radiance_lanes(data, spec, *lanes,
                                                         7)))
        want = torch.stack(list(megakernel.radiance_lanes_reference(
            data, spec, *lanes, 7)))
        torch.cuda.synchronize()
        assert _build.LAUNCHES[kernel] == before + 1
        assert torch.isfinite(got).all()
        if kernel == _build.KERNEL_TREE:
            assert torch.equal(got, want)
        else:
            d = (got - want).abs()
            ok = (d <= 1e-4 * want.abs().clamp(min=1)).all(dim=0)
            assert ok.float().mean() >= 0.99


@pytest.mark.cuda
def test_kernels_follow_a_cube_changed_in_place(cuda_device):
    """A cube modified in place between two calls, as a fitting step
    modifies it: the skybox kernel's and the linear kernel's answers
    follow it, equal to the plain version on the new cube."""
    data, spec = _sky_scene(cuda_device)
    rd = torch.from_numpy(_directions(1 << 16, 8)).to(cuda_device)
    first = backgrounds.background_color(data, spec, rd)
    n = 1 << 14
    lanes = [torch.arange(n, device=cuda_device) % spec.width,
             torch.arange(n, device=cuda_device) // spec.width % spec.height,
             torch.zeros(n, dtype=torch.int64, device=cuda_device),
             torch.zeros(n, dtype=torch.int64, device=cuda_device)]
    lin_first = torch.stack(list(megakernel.radiance_lanes(data, spec, *lanes,
                                                           3)))
    with torch.no_grad():
        data.bg_cube.mul_(0.5).add_(0.25)
    again = backgrounds.background_color(data, spec, rd)
    want = backgrounds._skybox(data.bg_cube, spec, rd)
    assert not torch.equal(again, first)
    assert ((again - want).abs() <= 1e-6).all(dim=1).float().mean() >= 0.999
    lin = torch.stack(list(megakernel.radiance_lanes(data, spec, *lanes, 3)))
    lin_want = torch.stack(list(megakernel.radiance_lanes_reference(
        data, spec, *lanes, 3)))
    assert not torch.equal(lin, lin_first)
    d = (lin - lin_want).abs()
    assert (d <= 1e-4 * lin_want.abs().clamp(min=1)).all(dim=0).float().mean() \
        >= 0.99
