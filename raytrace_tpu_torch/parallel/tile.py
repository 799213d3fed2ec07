"""Pixel-sharded rendering: the image's pixels split over the ranks.

PyTorch counterpart of :mod:`raytrace_tpu.parallel.tile`.  Each rank
renders its own contiguous pixel shard through the image loop
(:func:`raytrace_tpu_torch.render.integrator._image_loop` with a mesh, so
through ``sample_pixels`` and the kernels), the scene replicated; the
shards are gathered and the padding trimmed.  Every RNG draw is a pure
function of the (pixel, sample, level, slot) identity, never of a lane's
position, so the sharded image is the single-device image to the bit.
"""

from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.parallel.mesh import Mesh, make_mesh
from raytrace_tpu_torch.scene.schema import Scene


def render_image_sharded(scene: Scene, *, seed: int = 0,
                         spp: int | None = None, mesh: Mesh | None = None,
                         max_lanes: int = 1 << 22, progress=None,
                         checkpoint: str | None = None) -> np.ndarray:
    """Full-image render with the pixels sharded over the mesh's ranks
    (all of them, on the scene's device, by default).  Same tiling and
    checkpoint behaviour as
    :func:`raytrace_tpu_torch.render.integrator.render_image`, rank 0 the
    checkpoint's one writer and reader; the lane budget is per rank.
    Every rank calls it and gets the whole image."""
    from raytrace_tpu_torch.render.integrator import _image_loop

    mesh = mesh if mesh is not None else make_mesh(scene.data.device)
    if scene.data.device != mesh.device:
        raise ValueError(f"scene on {scene.data.device}, this rank renders "
                         f"on {mesh.device}")
    return _image_loop(scene, seed=seed, spp=spp,
                       max_lanes=max_lanes * mesh.ranks, progress=progress,
                       checkpoint=checkpoint, mesh=mesh)
