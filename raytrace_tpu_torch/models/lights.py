"""Light models: batched light-direction and range queries
(scene.rs:101-155).

PyTorch counterpart of :mod:`raytrace_tpu.models.lights`.  The light
type is static per light index (``SceneSpec.light_type``), so each
light's code path is chosen in Python.

* Point (scene.rs:122-127): direction = unit(location - pt), squared
  range = |location - pt|^2;
* Directional (scene.rs:135-139): direction = -direction, un-normalized,
  no range, so every shadow hit blocks;
* Area (scene.rs:151-155): a uniform random point on the parallelogram
  origin + side1*u + side2*v, then Point semantics.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops import rng
from raytrace_tpu_torch.ops.vec import V3, dot
from raytrace_tpu_torch.scene.schema import (LIGHT_AREA, LIGHT_DIRECTIONAL,
                                             LIGHT_POINT, SceneData)


def light_dir_and_sq_range(data: SceneData, light_type: int, li: int,
                           pt: V3, k1, k2, dtype):
    """Direction from ``pt`` to light ``li``.  Area-light draws fold the
    light index into the purpose id, so each area light has its own
    stream.  Returns ``(ldir: V3, sq_range, has_range: bool)``."""
    zero = torch.zeros_like(pt.x)
    if light_type == LIGHT_DIRECTIONAL:
        ldir = V3(zero - data.light_e1[li, 0], zero - data.light_e1[li, 1],
                  zero - data.light_e1[li, 2])
        return ldir, zero, False

    if light_type == LIGHT_AREA:
        u = rng.draw(k1, k2, rng.PURPOSE_LIGHT_U + 2 * li, dtype)
        v = rng.draw(k1, k2, rng.PURPOSE_LIGHT_V + 2 * li, dtype)
        loc = V3(data.light_p[li, 0] + data.light_e1[li, 0] * u
                 + data.light_e2[li, 0] * v,
                 data.light_p[li, 1] + data.light_e1[li, 1] * u
                 + data.light_e2[li, 1] * v,
                 data.light_p[li, 2] + data.light_e1[li, 2] * u
                 + data.light_e2[li, 2] * v)
    else:
        if light_type != LIGHT_POINT:
            raise ValueError(f"unknown light type {light_type}")
        loc = V3(zero + data.light_p[li, 0], zero + data.light_p[li, 1],
                 zero + data.light_p[li, 2])

    rel = loc - pt
    sq = dot(rel, rel)
    ldir = rel.scale(1.0 / torch.sqrt(torch.where(sq > 0, sq, 1.0)))
    return ldir, sq, True
