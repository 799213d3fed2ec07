"""Background models: solid color and six-face skybox (scene.rs:159-188,
raytrace.rs:228-256).

PyTorch counterpart of :mod:`raytrace_tpu.models.backgrounds`.  The
skybox lookup, :func:`_skybox`, is a masked select over the three axes
and a gather of four texels from the ``(6, H, W, 3)`` face array.  It is
the plain version of the CUDA lookup ``sky_lookup``
(``csrc/render_common.cuh``), which the render kernels call where a ray
misses and which :func:`background_color` launches on its own
(``csrc/skybox.cu``) for CUDA tensors.  The CUDA lookup reads the faces
in the form :func:`pack_sky` makes of the cube, each texel beside its
bilinear neighbours; :func:`sky_buffer` keeps the last one made.

Semantics kept exactly:

* dominant axis chosen by strict ``>`` comparisons, checked in x, y, z
  order; a tie for the largest component falls through to black
  (raytrace.rs:251-254);
* face UVs: x-face ``(-dz/dx, -dy/|dx|)``, y-face ``(dx/|dy|, dz/dy)``,
  z-face ``(dx/dz, -dy/|dz|)``, each mapped ``*0.5 + 0.5``
  (raytrace.rs:251-253);
* bilinear sample with clamp to [0,1], then scale by ``(size-1)`` of the
  face's own size, texel clamp at the high edge, y blended first
  (texture.rs:46-58).
"""

from __future__ import annotations

import ctypes

import torch

from raytrace_tpu_torch.ops import _build, intersect
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import BG_SKYBOX, SceneData, SceneSpec
from raytrace_tpu_torch.utils.profiling import BACKGROUND, annotate

# face order in SceneData.bg_cube (scene/builder.py): px nx py ny pz nz
FACE_PX, FACE_NX, FACE_PY, FACE_NY, FACE_PZ, FACE_NZ = range(6)


@annotate(BACKGROUND)
def background_color_v(data: SceneData, spec: SceneSpec, rd: V3) -> V3:
    """Background radiance for miss rays, component layout (the
    integrators' call at each node): plain PyTorch on every device, except
    that while a ring context is installed
    (:func:`raytrace_tpu_torch.ops.intersect.set_ring_ctx`) a skybox goes
    through :func:`background_color`, the skybox kernel on CUDA tensors."""
    if spec.bg_type != BG_SKYBOX:
        zero = torch.zeros_like(rd.x)
        return V3(zero + data.bg_color[0], zero + data.bg_color[1],
                  zero + data.bg_color[2])
    dirs = torch.stack([rd.x, rd.y, rd.z], -1)
    if intersect.ring_ctx() is not None:
        out = background_color(data, spec,
                               dirs.reshape(-1, 3)).reshape(dirs.shape)
    else:
        out = _skybox(data.bg_cube, spec, dirs)
    return V3(out[..., 0], out[..., 1], out[..., 2])


@annotate(BACKGROUND)
def background_color(data: SceneData, spec: SceneSpec,
                     rd: torch.Tensor) -> torch.Tensor:
    """Background radiance for miss rays ``rd`` (N, 3) -> (N, 3).  A
    skybox on CUDA tensors launches ``csrc/skybox.cu`` or raises: the
    kernel is float32, so float64 raises there, naming ROADMAP item 12
    (gradients come from :func:`_skybox`, the forward is still the
    kernel).  On CPU tensors it is :func:`_skybox`."""
    if spec.bg_type != BG_SKYBOX:
        return data.bg_color.expand(rd.shape)
    cube = data.bg_cube
    if rd.device != cube.device:
        raise ValueError(f"cube on {cube.device}, directions on {rd.device}")
    if rd.device.type == "cpu":
        return _skybox(cube, spec, rd)
    if rd.device.type != "cuda":
        raise ValueError(f"no skybox kernel for device {rd.device}")
    if rd.dtype != torch.float32 or cube.dtype != torch.float32:
        raise NotImplementedError(
            "the skybox kernel is float32; float64 renders on CPU "
            "tensors, as in the reference (ROADMAP item 12)")
    return kernel_forward(lambda c, d: (_launch(c, spec, d),),
                          lambda c, d: (_skybox(c, spec, d),), cube, rd,
                          name=_build.KERNEL_SKY)[0]


def _skybox(cube: torch.Tensor, spec: SceneSpec,
            rd: torch.Tensor) -> torch.Tensor:
    """The skybox radiance of directions ``rd`` (..., 3) from the padded
    faces ``cube`` (6, H, W, 3), each face at its own size
    ``spec.face_sizes``.  Differentiable in ``cube`` and ``rd``."""
    dtype = rd.dtype
    dx, dy, dz = rd[..., 0], rd[..., 1], rd[..., 2]
    ax, ay, az = torch.abs(dx), torch.abs(dy), torch.abs(dz)

    # dominant-axis tests in the reference's x, y, z order (strict >)
    x_dom = (ax > az) & (ax > ay)
    y_dom = (ay > ax) & (ay > az)
    z_dom = (az > ax) & (az > ay)
    any_dom = x_dom | y_dom | z_dom

    face = torch.where(
        x_dom, torch.where(dx > 0, FACE_PX, FACE_NX),
        torch.where(y_dom, torch.where(dy > 0, FACE_PY, FACE_NY),
                    torch.where(dz > 0, FACE_PZ, FACE_NZ)))

    # one division per coordinate, of the selected operands only, so that
    # no lane divides by an unselected tiny component (whose infinite
    # quotient would poison the gradient of the branch taken); lanes
    # without a dominant axis divide by 1 and are black below
    def ratio(num, den):
        den = torch.where(any_dom & (den != 0), den, 1.0)
        return torch.where(any_dom, num, 0.0) / den

    u = ratio(torch.where(x_dom, -dz, dx),
              torch.where(x_dom, dx, torch.where(y_dom, ay, dz)))
    v = ratio(torch.where(y_dom, dz, -dy),
              torch.where(x_dom, ax, torch.where(y_dom, dy, az)))
    u = u * 0.5 + 0.5
    v = v * 0.5 + 0.5

    # each face's own size (the faces are padded into one array)
    sizes = torch.tensor(spec.face_sizes, dtype=torch.int64,
                         device=rd.device)                    # (6, 2) h, w
    fh_i, fw_i = sizes[:, 0][face], sizes[:, 1][face]
    fh, fw = fh_i.to(dtype), fw_i.to(dtype)

    # Texture::sample (texture.rs:46-58): clamp, scale by size-1, bilinear
    x = torch.clamp(u, 0.0, 1.0) * (fw - 1.0)
    y = torch.clamp(v, 0.0, 1.0) * (fh - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    xx = (x - x0)[..., None]
    yy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    x1i = torch.minimum(x0i + 1, fw_i - 1)
    y1i = torch.minimum(y0i + 1, fh_i - 1)

    c00 = cube[face, y0i, x0i]
    c01 = cube[face, y1i, x0i]
    c10 = cube[face, y0i, x1i]
    c11 = cube[face, y1i, x1i]
    cx0 = c00 * (1.0 - yy) + c01 * yy
    cx1 = c10 * (1.0 - yy) + c11 * yy
    out = cx0 * (1.0 - xx) + cx1 * xx
    return torch.where(any_dom[..., None], out, 0.0)


def face_sizes_arg(cube: torch.Tensor, spec: SceneSpec):
    """What the CUDA lookups take beside the packed faces' pointer: 14 C
    ints, the padded height and width and each face's own (csrc/
    render_common.cuh, make_sky).  Raises unless the cube is what they
    read: (6, H, W, 3) float32, contiguous, on a CUDA device, every face
    within the padding."""
    if (cube.dtype != torch.float32 or cube.ndim != 4 or cube.shape[0] != 6
            or cube.shape[3] != 3 or not cube.is_contiguous()
            or cube.device.type != "cuda"):
        raise ValueError("the skybox cube must be a contiguous (6, H, W, 3) "
                         "float32 CUDA tensor")
    hmax, wmax = cube.shape[1], cube.shape[2]
    if len(spec.face_sizes) != 6 or any(
            not (1 <= h <= hmax and 1 <= w <= wmax)
            for h, w in spec.face_sizes):
        raise ValueError(f"face sizes {spec.face_sizes} do not fit the "
                         f"cube's {hmax}x{wmax} padding")
    flat = [hmax, wmax, *(n for hw in spec.face_sizes for n in hw)]
    return (ctypes.c_int * 14)(*flat)


# floats of one texel of the packed faces: the texel and its three
# bilinear neighbours, RGB each, and 4 of pad (one 64-byte block)
SKY_QUAD = 16


def pack_sky(cube: torch.Tensor, face_sizes) -> torch.Tensor:
    """The faces as the CUDA lookups read them (``csrc/render_common.cuh``,
    ``Sky``): a (6, H, W, 16) tensor of ``cube``'s dtype whose entry
    (f, y, x) holds texels (y, x), (y1, x), (y, x1) and (y1, x1) of face
    f, RGB each, with ``x1 = min(x + 1, w - 1)`` and ``y1 = min(y + 1,
    h - 1)`` at the face's own size (h, w) of ``face_sizes``, then four
    zeros.  Entries outside a face's own size are zero: the lookup never
    reads them.  Plain PyTorch, without gradient; 16/3 of the cube's
    bytes."""
    _, hmax, wmax, _ = cube.shape
    cube = cube.detach()
    out = cube.new_zeros((6, hmax, wmax, SKY_QUAD))
    for f, (h, w) in enumerate(face_sizes):
        face = cube[f, :h, :w]
        y1 = torch.arange(1, h + 1, device=cube.device).clamp(max=h - 1)
        x1 = torch.arange(1, w + 1, device=cube.device).clamp(max=w - 1)
        out[f, :h, :w, 0:3] = face
        out[f, :h, :w, 3:6] = face[y1]
        out[f, :h, :w, 6:9] = face[:, x1]
        out[f, :h, :w, 9:12] = face[y1][:, x1]
    return out


# the last packed form made: (cube, (version, data pointer, face sizes),
# packed), reused while the same cube comes unmodified
_sky_last = None


def cached_pack_sky(cube: torch.Tensor, face_sizes) -> torch.Tensor:
    """:func:`pack_sky`, made anew only when ``cube`` is another tensor or
    was modified in place (its ``_version``), as a fitting step modifies
    it, or the face sizes differ."""
    global _sky_last
    key = (cube._version, cube.data_ptr(), tuple(map(tuple, face_sizes)))
    if (_sky_last is not None and _sky_last[0] is cube
            and _sky_last[1] == key):
        return _sky_last[2]
    packed = pack_sky(cube, face_sizes)
    _sky_last = (cube, key, packed)
    return packed


def sky_buffer(cube: torch.Tensor, spec: SceneSpec):
    """(packed faces, face sizes) as the CUDA lookups take them: the
    :func:`cached_pack_sky` form of ``cube`` and :func:`face_sizes_arg`.
    Raises for faces whose packed form has more elements than the
    lookup's 32-bit index reaches, and where :func:`face_sizes_arg`
    does."""
    if cube.numel() // 3 * SKY_QUAD >= 2 ** 31:
        raise ValueError(f"a {tuple(cube.shape)} cube packs to 2**31 floats "
                         f"or more, beyond the lookup's 32-bit index")
    face_hw = face_sizes_arg(cube.detach().contiguous(), spec)
    return cached_pack_sky(cube, spec.face_sizes), face_hw


_lib_ready: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _lib_ready
    if _lib_ready is None:
        lib = _build.load(_build.KERNEL_SKY)
        lib.rt_skybox.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                                          ctypes.c_void_p]
        lib.rt_skybox.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib_ready = lib
    return _lib_ready


def _launch(cube: torch.Tensor, spec: SceneSpec,
            rd: torch.Tensor) -> torch.Tensor:
    if rd.dtype != torch.float32 or rd.ndim != 2 or rd.shape[1] != 3:
        raise ValueError("directions must be an (N, 3) float32 tensor")
    packed, face_hw = sky_buffer(cube, spec)
    rd = rd.detach().contiguous()
    out = torch.empty_like(rd)
    n = rd.shape[0]
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(rd.device):
        stream = torch.cuda.current_stream(rd.device).cuda_stream
        rc = lib.rt_skybox(packed.data_ptr(), face_hw, rd.data_ptr(),
                           out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"skybox launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    _build.LAUNCHES[_build.KERNEL_SKY] += 1
    return out
