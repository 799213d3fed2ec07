"""Camera models: batched primary-ray generation (camera.rs).

PyTorch counterpart of :mod:`raytrace_tpu.models.cameras`: the simple
perspective camera (camera.rs:77-79) and the depth-of-field camera
(camera.rs:110-122).
"""

from __future__ import annotations

import math

import torch

from raytrace_tpu_torch.ops import rng, vec
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import (CAM_DEPTH_OF_FIELD, SceneData,
                                             SceneSpec)


def _mat_apply(m, x, y, z) -> V3:
    """dir = M @ (x, y, z) with scalar matrix entries against lanes."""
    return V3(m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
              m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
              m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def project(data: SceneData, spec: SceneSpec, pos_x, pos_y, k1, k2):
    """Project normalized image coordinates to rays.

    ``pos_x``/``pos_y``: NDC coordinates ((-1,-1)..(1,1) = the largest
    centered square in the image, camera.rs:22-24).  ``k1``/``k2`` are
    the per-lane RNG streams, which only the lens sampler uses.
    Returns ``(origin: V3, direction: V3)``.
    """
    m = data.cam_matrix
    d = _mat_apply(m, pos_x, pos_y, torch.ones_like(pos_x))
    zero = torch.zeros_like(pos_x)
    cam_pos = V3(zero + data.cam_position[0], zero + data.cam_position[1],
                 zero + data.cam_position[2])
    if spec.cam_type != CAM_DEPTH_OF_FIELD:
        return cam_pos, vec.normalize(d)

    # DepthOfFieldCamera::project (camera.rs:110-121): d stays
    # un-normalized; the lens point is uniform on a disc, theta ~
    # U[0,2pi), r = sqrt(u) * aperture
    dtype = pos_x.dtype
    ip = cam_pos + d
    fp = cam_pos + d.scale(data.cam_focus / data.cam_im_dist)
    theta = rng.draw(k1, k2, rng.PURPOSE_LENS_THETA, dtype) * (2.0 * math.pi)
    u = rng.draw(k1, k2, rng.PURPOSE_LENS_R, dtype)
    r = torch.sqrt(u) * data.cam_aperture
    lens = _mat_apply(m, torch.cos(theta) * r, torch.sin(theta) * r,
                      torch.zeros_like(r))
    origin = ip + lens
    return origin, vec.normalize(fp - origin)
