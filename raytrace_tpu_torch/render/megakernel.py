"""The render megakernel: per-lane radiance through one CUDA kernel.

PyTorch counterpart of :mod:`raytrace_tpu.render.megakernel` in its small
linear regime.  :func:`radiance_lanes` takes per-lane integer identities
(pixel x, pixel y, antialias sample, lens sample) and returns their
radiance: on CUDA tensors it launches the hand-written kernel
``csrc/megakernel_linear.cu`` (one thread per lane, the whole chain in
registers) or raises; on CPU tensors it runs the plain PyTorch version,
:func:`radiance_lanes_reference`.  Scenes outside :func:`usable` raise
``NotImplementedError`` naming the ROADMAP item on every device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytrace_tpu_torch.models.materials import unported_feature
from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.ops.intersect import (
    COL_AMBIENT, COL_DIFFUSE, COL_INDIRECT, COL_P, COL_Q, COL_SAMPLES,
    COL_SPHERE, LARGE_SCENE_THRESHOLD, object_table)
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import (BG_SOLID, CAM_SIMPLE_PERSPECTIVE,
                                             SceneData, SceneSpec)

KERNEL = "megakernel_linear"

# kernel launches in this process (chip_smoke.py resets and reads it to
# show that a run went through the kernel)
LAUNCHES = 0

# object_table() columns of the kernel's 16-float object row, in the
# order csrc/megakernel_linear.cu reads them (R_P .. R_IND), plus a pad
_ROW_COLS = [COL_P, COL_P + 1, COL_P + 2, COL_Q, COL_Q + 1, COL_Q + 2,
             COL_DIFFUSE, COL_DIFFUSE + 1, COL_DIFFUSE + 2,
             COL_AMBIENT, COL_AMBIENT + 1, COL_AMBIENT + 2,
             COL_SAMPLES, COL_SPHERE, COL_INDIRECT]


def unsupported_reason(data: SceneData, spec: SceneSpec) -> str | None:
    """Why this scene is outside the ported slice, or None."""
    if data.dtype != torch.float32:
        return "float64 rendering is not ported yet (ROADMAP item 12)"
    if len(spec.live_objects()) > LARGE_SCENE_THRESHOLD:
        return (f"scenes with more than {LARGE_SCENE_THRESHOLD} objects are "
                f"not ported yet (ROADMAP item 10)")
    if spec.children_per_ray > 1:
        return "fan-out scenes are not ported yet (ROADMAP item 9)"
    if spec.bg_type != BG_SOLID:
        return "skybox backgrounds are not ported yet (ROADMAP item 11)"
    if spec.cam_type != CAM_SIMPLE_PERSPECTIVE:
        return "the depth-of-field camera is not ported yet (ROADMAP item 8)"
    return unported_feature(spec)


def usable(data: SceneData, spec: SceneSpec) -> bool:
    """Whether this scene renders through :func:`radiance_lanes`."""
    return unsupported_reason(data, spec) is None


def radiance_lanes(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                   seed: int) -> V3:
    """Radiance of each lane, given (N,) integer identity tensors on the
    scene's device.  Returns a V3 of (N,) float32 tensors."""
    if any(getattr(data, f.name).requires_grad
           for f in dataclasses.fields(data)):
        raise NotImplementedError(
            "gradients through the megakernel are not ported yet "
            "(ROADMAP item 7)")
    reason = unsupported_reason(data, spec)
    if reason is not None:
        raise NotImplementedError(reason)
    device = pix.device
    for t in (pix, piy, aa, cam):
        if t.device != device or t.shape != pix.shape or t.ndim != 1:
            raise ValueError("lane ids must be (N,) tensors on one device")
    if data.device != device:
        raise ValueError(f"scene on {data.device}, lanes on {device}")
    if device.type == "cuda":
        return _launch(data, spec, pix, piy, aa, cam, seed)
    if device.type == "cpu":
        return radiance_lanes_reference(data, spec, pix, piy, aa, cam, seed)
    raise ValueError(f"no megakernel for device {device}")


def radiance_lanes_reference(data: SceneData, spec: SceneSpec, pix, piy, aa,
                             cam, seed: int) -> V3:
    """The plain PyTorch version of the kernel, on any device."""
    from raytrace_tpu_torch.render.integrator import (primary_rays,
                                                      radiance_linear_v)

    ro, rd, k1, k2 = primary_rays(data, spec, pix, piy, aa, cam, seed)
    return radiance_linear_v(data, spec, ro, rd, k1, k2)


def pack_scene(data: SceneData, spec: SceneSpec) -> torch.Tensor:
    """The kernel's float32 scene buffer on the scene's device: a 19-float
    header (camera position, row-major camera matrix, background color,
    half width, half height, NDC scale, minimum significance), then one
    16-float row per live object in scene order."""
    halfw, halfh = spec.width / 2.0, spec.height / 2.0
    consts = torch.tensor([halfw, halfh, max(1.0 / halfw, 1.0 / halfh),
                           spec.min_significance], dtype=torch.float64)
    live = spec.live_objects()
    rows = object_table(data, spec)[live][:, _ROW_COLS]
    rows = torch.cat([rows, torch.zeros_like(rows[:, :1])], dim=1)
    return torch.cat([
        data.cam_position, data.cam_matrix.reshape(9), data.bg_color,
        consts.to(device=data.device, dtype=torch.float32),
        rows.reshape(-1)]).to(torch.float32).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    lib.rt_megakernel_linear.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    lib.rt_megakernel_linear.restype = ctypes.c_int
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    return lib


def _launch(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
            seed: int) -> V3:
    global LAUNCHES
    device = pix.device
    n = pix.shape[0]
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    if n == 0:
        return V3(out[0], out[1], out[2])
    lib = _lib()
    # 32-bit lane words, which the kernel reads as uint32_t
    ids = [t.contiguous() if t.dtype == torch.int32
           else (t.to(torch.int64) & 0xFFFFFFFF).to(torch.int32).contiguous()
           for t in (pix, piy, aa, cam)]
    scene = pack_scene(data, spec)
    levels = spec.max_depth + 2 if spec.n_indirect else 1
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.rt_megakernel_linear(
            *(t.data_ptr() for t in ids), scene.data_ptr(),
            len(spec.live_objects()), levels, int(seed) & 0xFFFFFFFF,
            out.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"megakernel launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    LAUNCHES += 1
    return V3(out[0], out[1], out[2])
