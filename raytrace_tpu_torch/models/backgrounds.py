"""Background models (scene.rs:159-188, raytrace.rs:228-256).

PyTorch counterpart of :mod:`raytrace_tpu.models.backgrounds`.  Only the
solid-color background is ported.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import BG_SOLID, SceneData, SceneSpec


def background_color_v(data: SceneData, spec: SceneSpec, rd: V3) -> V3:
    """Background radiance for miss rays, component layout."""
    if spec.bg_type != BG_SOLID:
        raise NotImplementedError(
            "skybox backgrounds are not ported yet (ROADMAP item 11)")
    zero = torch.zeros_like(rd.x)
    return V3(zero + data.bg_color[0], zero + data.bg_color[1],
              zero + data.bg_color[2])
