"""Multi-process rendering into one BMP: each rank renders and writes its
own band of whole rows.

PyTorch counterpart of :mod:`raytrace_tpu.parallel.multihost`.  The
reference streams rows to disk as they finish (main.rs:56-58); here each
rank renders a contiguous band of the image's rows on its own device and
writes only those rows into the shared BMP, so no rank ever holds the
whole image.  Rendering needs no collective (the RNG keys by the global
pixel identity, so the bands are the single-process image's rows to the
bit); the scene is broadcast from rank 0 once, and two barriers order
the file's header before any band and every band before the return.

Bring-up is :func:`raytrace_tpu_torch.parallel.mesh.maybe_init_distributed`,
which the CLI calls before any device query.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

from raytrace_tpu_torch.io import bmp
from raytrace_tpu_torch.parallel.mesh import (Mesh, broadcast_, make_mesh,
                                              process_count)
from raytrace_tpu_torch.scene.schema import Scene, SceneData


def replicate_to_mesh(data: SceneData, mesh: Mesh) -> SceneData:
    """Rank 0's scene tensors on every rank (a broadcast of each leaf)."""
    if mesh.ranks == 1:
        return data
    return SceneData(**{f.name: broadcast_(getattr(data, f.name).clone(),
                                           mesh)
                        for f in dataclasses.fields(data)})


def render_rows_multihost(scene: Scene, *, seed: int = 0,
                          spp: int | None = None, mesh: Mesh | None = None,
                          max_lanes: int = 1 << 22,
                          progress=None) -> tuple[int, int, np.ndarray]:
    """Render THIS rank's band of the image's rows.

    Returns ``(row_lo, row_hi, band)``, ``band`` the ``(row_hi - row_lo,
    W, 3)`` float64 linear radiance of those rows (row 0 of the image =
    bottom, BMP order).  Every rank calls it.  The rows are padded up to a
    multiple of the ranks and each rank renders ``ceil(H / ranks)`` of
    them, so every (W, H, ranks) renders; pad rows re-render the image's
    top row and are trimmed before the return (a rank with pad rows only
    returns a band of no rows).  The band goes through the image loop
    (:func:`raytrace_tpu_torch.render.integrator._image_loop`), tiled and
    sampled as the whole image is."""
    from raytrace_tpu_torch.render.integrator import _image_loop

    mesh = mesh if mesh is not None else make_mesh(scene.data.device)
    data = replicate_to_mesh(scene.data, mesh)
    w, h = scene.spec.width, scene.spec.height
    rows = -(-h // mesh.ranks)
    lo_row = mesh.rank * rows
    band = _image_loop(dataclasses.replace(scene, data=data), seed=seed,
                       spp=spp, max_lanes=max_lanes, progress=progress,
                       checkpoint=None, rows=(lo_row, lo_row + rows))
    row_lo, row_hi = min(lo_row, h), min(lo_row + rows, h)
    return row_lo, row_hi, band[:row_hi - row_lo]


def write_bmp_band(path: str, width: int, height: int, row_lo: int,
                   band_srgb: np.ndarray) -> None:
    """Write this rank's rows into the shared BMP at their byte offset.
    The file must exist with its header (:func:`ensure_bmp_file`)."""
    with open(path, "r+b") as f:
        f.seek(122 + row_lo * bmp.row_stride(width))
        f.write(bmp.encode_rows(band_srgb).tobytes())


def ensure_bmp_file(path: str, width: int, height: int) -> None:
    """Create (or truncate) the BMP with its header and a zeroed pixel
    array sized for the whole image."""
    with open(path, "wb") as f:
        f.write(bmp.header(width, height))
        f.truncate(122 + bmp.row_stride(width) * height)


def render_to_bmp_multihost(scene: Scene, path: str, *, seed: int = 0,
                            spp: int | None = None,
                            max_lanes: int = 1 << 22, progress=None,
                            mesh: Mesh | None = None) -> None:
    """The whole multi-process pipeline: every rank renders its band,
    encodes it to sRGB and writes it into ``path``, which every rank must
    see (one host: trivially)."""
    mesh = mesh if mesh is not None else make_mesh(scene.data.device)
    spec = scene.spec
    row_lo, _, band = render_rows_multihost(
        scene, seed=seed, spp=spp, mesh=mesh, max_lanes=max_lanes,
        progress=progress)
    if mesh.rank == 0:
        ensure_bmp_file(path, spec.width, spec.height)
    # every rank waits for the file to exist before seeking into it
    _barrier("bmp_header")
    write_bmp_band(path, spec.width, spec.height, row_lo,
                   bmp.encode_srgb(band))
    _barrier("bmp_rows")


def _barrier(tag: str) -> None:
    """Wait for every rank.  A failed barrier is a HARD error: it orders
    the shared BMP's writes (the header before any band, every band
    before the return), and going on after a sleep would race the header
    write and corrupt the file it protects.  Callers that cannot sync
    must not write."""
    if process_count() <= 1:
        return
    try:
        dist.barrier()
    except Exception as e:
        raise RuntimeError(
            f"multi-host barrier '{tag}' failed; aborting the shared-BMP "
            f"write rather than racing it (every process must reach this "
            f"barrier for the write protocol to be safe)") from e
