"""Camera models: batched primary-ray generation (camera.rs).

PyTorch counterpart of :mod:`raytrace_tpu.models.cameras`.  Only the
simple perspective camera (camera.rs:77-79) is ported.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import vec
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import (CAM_SIMPLE_PERSPECTIVE,
                                             SceneData, SceneSpec)


def _mat_apply(m, x, y, z) -> V3:
    """dir = M @ (x, y, z) with scalar matrix entries against lanes."""
    return V3(m[0, 0] * x + m[0, 1] * y + m[0, 2] * z,
              m[1, 0] * x + m[1, 1] * y + m[1, 2] * z,
              m[2, 0] * x + m[2, 1] * y + m[2, 2] * z)


def project(data: SceneData, spec: SceneSpec, pos_x, pos_y, k1, k2):
    """Project normalized image coordinates to rays.

    ``pos_x``/``pos_y``: NDC coordinates ((-1,-1)..(1,1) = the largest
    centered square in the image, camera.rs:22-24).  ``k1``/``k2`` are
    the per-lane RNG streams, which only a lens sampler would use.
    Returns ``(origin: V3, direction: V3)``.
    """
    if spec.cam_type != CAM_SIMPLE_PERSPECTIVE:
        raise NotImplementedError(
            "the depth-of-field camera is not ported yet (ROADMAP item 8)")
    d = _mat_apply(data.cam_matrix, pos_x, pos_y, torch.ones_like(pos_x))
    zero = torch.zeros_like(pos_x)
    cam_pos = V3(zero + data.cam_position[0], zero + data.cam_position[1],
                 zero + data.cam_position[2])
    return cam_pos, vec.normalize(d)
