"""Entry points of the port: the golden path's forward, and a dry
run of the sharded training step over the ranks of a process group.

PyTorch counterpart of the JAX package's ``__graft_entry__.py``:
:func:`entry` returns the forward (``sample_pixels`` on the golden scene
at 64x64, 128 pixels, 2 sample ids, seed 0) with its example arguments,
and :func:`dryrun_multichip` runs one sharded training step, one Adam
update and a sharded render on n ranks.  The golden scene is
``examples/cornell_indirect.txt`` unless the caller names another (the
reference snapshot's ``test_scene.txt`` is not part of the repository).

    python3 -m raytrace_tpu_torch.entry [--device cuda|cpu]

prints the forward's shape and mean.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch

from raytrace_tpu_torch.bench import CORNELL


def golden_scene(device, width: int = 64, height: int = 64,
                 scene_path: str = CORNELL):
    """The golden scene on ``device`` at ``width`` x ``height``."""
    from raytrace_tpu_torch.scene.builder import load_scene_file

    sc = load_scene_file(scene_path, device=device)
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=width, height=height))


def entry(device="cuda", scene_path: str = CORNELL):
    """(forward, example_args): ``forward(data, px, py, sample_ids)`` is
    :func:`sample_pixels` of the golden scene at 64x64 with seed 0 (on
    CUDA tensors K1), the arguments its data, pixels 0-127 as x and y, and
    sample ids 0 and 1, on ``device``."""
    from raytrace_tpu_torch.render.integrator import sample_pixels

    device = torch.device(device)
    sc = golden_scene(device, scene_path=scene_path)
    spec = sc.spec

    def forward(data, px, py, sample_ids):
        return sample_pixels(data, spec, px, py, sample_ids, seed=0)

    pix = torch.arange(128, dtype=torch.int64, device=device)
    example_args = (sc.data, pix % spec.width, pix // spec.width,
                    torch.arange(2, dtype=torch.int64, device=device))
    return forward, example_args


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded training step (pixels split over the ranks, the loss
    and gradients summed over them), one Adam update (lr 1e-2) of the
    scene, and a sharded render at 2 samples per pixel, on the golden
    scene at 8 x ``n_devices`` over the ``n_devices`` ranks of the process
    group: a 2-level ("dcn", "ici") mesh of 2 x n/2 when n is even and
    above 2, else a flat one.  Every rank calls it together, rendering on
    ``device`` (by default its card).  Raises unless the loss and the image
    are finite and the update moved the scene; prints one line and
    returns the mesh's shape, the loss, the largest change the update made
    and the image."""
    from raytrace_tpu_torch.optim import make_sharded_step
    from raytrace_tpu_torch.parallel.mesh import (make_mesh, make_mesh_2d,
                                                  process_count)
    from raytrace_tpu_torch.parallel.tile import render_image_sharded
    from raytrace_tpu_torch.scene.schema import SceneData

    if process_count() != n_devices:
        raise ValueError(f"need {n_devices} ranks, the process group has "
                         f"{process_count()}")
    mesh = (make_mesh_2d(2, device) if n_devices % 2 == 0 and n_devices > 2
            else make_mesh(device))
    sc = golden_scene(mesh.device, width=8, height=n_devices)
    w, h = sc.spec.width, sc.spec.height
    pix = torch.arange(w * h, dtype=torch.int64, device=mesh.device)
    sids = torch.arange(2, dtype=torch.int64, device=mesh.device)
    target = torch.zeros((w * h, 3), dtype=sc.data.dtype, device=mesh.device)

    step = make_sharded_step(sc.spec, mesh, seed=0)
    loss, grads = step(sc.data, pix % w, pix // w, sids, target)
    if not torch.isfinite(loss):
        raise RuntimeError(f"the sharded step's loss is {float(loss)}")

    names = [f.name for f in dataclasses.fields(sc.data)]
    params = [getattr(sc.data, n).clone().requires_grad_() for n in names]
    for p, n in zip(params, names):
        p.grad = getattr(grads, n)
    torch.optim.Adam(params, lr=1e-2).step()
    new_data = SceneData(**{n: p.detach() for n, p in zip(names, params)})
    moved = max(float((getattr(new_data, n) - getattr(sc.data, n)).abs()
                      .max()) for n in names)
    if not moved > 0:
        raise RuntimeError("the Adam update left the scene as it was")

    # the sharded forward render too (the pixels split over the mesh)
    img = render_image_sharded(sc, seed=0, spp=2, mesh=mesh)
    if not np.isfinite(img).all():
        raise RuntimeError("the sharded render is not finite")
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} "
          f"loss={float(loss):.4f} ok")
    return {"mesh": mesh.shape, "loss": float(loss), "moved": moved,
            "image": img}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="raytrace_tpu_torch.entry",
        description="the golden path's forward: its shape and mean")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to run on (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but PyTorch sees no CUDA device",
              file=sys.stderr)
        return 1
    fn, example_args = entry(args.device)
    with torch.no_grad():
        out = fn(*example_args)
    print("entry forward:", tuple(out.shape), float(out.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
