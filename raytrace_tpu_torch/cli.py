"""Command-line entry point (main.rs): scene file -> render -> sRGB -> BMP.

Same positional argument and flags as ``raytrace_tpu.cli``, plus
``--device``.  On ``--device cuda`` every lane goes through a CUDA
megakernel (the linear one or the tree one, for fan-out trees of any
depth; a skybox scene's faces are loaded from the image files it names,
relative to the scene file), and a machine without a usable GPU is an
error, never a silent CPU render.  ``--device cpu`` renders every scene
through the kernels' plain version, ``--f64`` (float64, CPU only, as in
the JAX package's CLI) included.  ``--profile DIR`` records the render
and its encode with ``torch.profiler`` and writes a Chrome trace into
DIR, whose ranges name the render phases, the kernels, the image loop's
steps and ``srgb_encode`` (:mod:`raytrace_tpu_torch.utils.profiling`).
``--shard`` shards the pixels over the ranks of the process group,
``--shard-objects`` the objects too (a ring, whose steps are the CUDA
scan kernel).  Run as several processes under the environment protocol
of :func:`raytrace_tpu_torch.parallel.mesh.maybe_init_distributed`, each
rank renders its band of rows into the one BMP.

    python -m raytrace_tpu_torch.cli examples/materials_showcase.txt \\
        -o out.bmp --device cuda
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="raytrace_tpu_torch",
        description="raytracer on PyTorch with CUDA kernels")
    p.add_argument("scene", nargs="?", default="test_scene.txt",
                   help="scene DSL file (default: test_scene.txt, main.rs:16)")
    p.add_argument("-o", "--output", default="out.bmp",
                   help="output BMP path (default: out.bmp, main.rs:34)")
    p.add_argument("--spp", type=int, default=None,
                   help="override the scene's antialias sample count")
    p.add_argument("--width", type=int, default=None,
                   help="override render width")
    p.add_argument("--height", type=int, default=None,
                   help="override render height")
    p.add_argument("--seed", type=int, default=0, help="RNG seed")
    p.add_argument("--f64", action="store_true",
                   help="render in float64 (--device cpu only)")
    p.add_argument("--max-lanes", type=int, default=1 << 22,
                   help="lane budget per launch (memory knob)")
    p.add_argument("--shard", action="store_true",
                   help="shard pixels over the process group's ranks")
    p.add_argument("--shard-objects", action="store_true",
                   help="ring-shard the scene's objects over the ranks "
                        "(for scenes too large to replicate); implies "
                        "pixel sharding")
    p.add_argument("--checkpoint", default=None,
                   help="npz path for resumable rendering state")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace (Chrome's format) "
                        "of the render into this directory")
    p.add_argument("--log-json", default=None,
                   help="append structured log events to this JSONL file")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to render on (default: cuda)")
    p.add_argument("-q", "--quiet", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.f64 and args.device == "cuda":
        print("error: --f64 renders on the CPU, as in the reference: use "
              "--device cpu (ROADMAP item 12)", file=sys.stderr)
        return 2

    import torch

    from raytrace_tpu_torch.parallel import mesh as meshlib

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but PyTorch sees no CUDA device",
              file=sys.stderr)
        return 1
    # multi-process bring-up before any other device query; a no-op
    # unless the environment configures a process group
    meshlib.maybe_init_distributed(args.device)
    multiproc = meshlib.process_count() > 1

    from raytrace_tpu_torch.io import bmp
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.render.integrator import render_image
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.dsl import SceneSyntaxError
    from raytrace_tpu_torch.utils.logging import RenderLog

    device = (meshlib.rank_device(meshlib.process_index())
              if multiproc and args.device == "cuda"
              else torch.device(args.device))
    log = RenderLog(json_path=args.log_json, quiet=args.quiet)

    try:
        with log.phase("load_scene", path=args.scene):
            scene = load_scene_file(
                args.scene, device=device,
                dtype=torch.float64 if args.f64 else torch.float32)
    except (OSError, SceneSyntaxError) as e:
        print(f"error: {e}", file=sys.stderr)  # main.rs:18,28 shape
        return 1

    spec = scene.spec
    overrides = {k: v for k, v in (("width", args.width),
                                   ("height", args.height)) if v is not None}
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
        scene = dataclasses.replace(scene, spec=spec)
    # the kernels take every float32 scene; float64 was refused above
    reason = megakernel.unsupported_reason(scene.data, spec)
    if reason is not None and device.type == "cuda":
        print(f"error: {reason}", file=sys.stderr)
        return 1

    spp = args.spp if args.spp is not None else max(spec.antialias, 1)
    log.event("scene", objects=spec.n_objects, lights=spec.n_lights,
              size=f"{spec.width}x{spec.height}", spp=spp,
              branching=spec.children_per_ray, device=str(device),
              device_name=(torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"))
    n_primary = spec.width * spec.height * spp * spec.cam_samples

    def progress(frac):
        if not args.quiet:
            print(f"\r[raytrace_tpu_torch] render {100 * frac:5.1f}%",
                  end="", file=sys.stderr, flush=True)

    prof = _start_profile(device) if args.profile else None
    launches0 = sum(megakernel.LAUNCHES.values())
    t0 = time.perf_counter()
    if multiproc:
        # each rank renders and writes its band of rows into the one BMP;
        # the encode and write are part of the render
        from raytrace_tpu_torch.parallel.multihost import (
            render_to_bmp_multihost)
        render_to_bmp_multihost(scene, args.output, seed=args.seed, spp=spp,
                                max_lanes=args.max_lanes, progress=progress)
        dt = time.perf_counter() - t0
        if prof is not None:
            _stop_profile(prof, device, args.profile, log,
                          f"trace_rank{meshlib.process_index()}.json")
        if not args.quiet:
            print("", file=sys.stderr)
        log.event("render_done", seconds=round(dt, 3),
                  primary_samples=n_primary,
                  samples_per_sec=round(n_primary / dt),
                  rays_per_sec=round(n_primary * (spec.max_depth + 2) / dt),
                  kernel_launches=sum(megakernel.LAUNCHES.values())
                  - launches0,
                  processes=meshlib.process_count())
        return 0
    if args.shard_objects:
        from raytrace_tpu_torch.parallel.ring import render_image_ring
        render = render_image_ring
    elif args.shard:
        from raytrace_tpu_torch.parallel.tile import render_image_sharded
        render = render_image_sharded
    else:
        render = render_image
    img = render(scene, seed=args.seed, spp=spp, max_lanes=args.max_lanes,
                 progress=progress, checkpoint=args.checkpoint)
    dt = time.perf_counter() - t0
    if not args.quiet:
        print("", file=sys.stderr)
    # one ray = one closest-hit round; a primary sample runs max_depth+2
    log.event("render_done", seconds=round(dt, 3),
              primary_samples=n_primary,
              samples_per_sec=round(n_primary / dt),
              rays_per_sec=round(n_primary * (spec.max_depth + 2) / dt),
              kernel_launches=sum(megakernel.LAUNCHES.values()) - launches0,
              nonfinite=int(np.count_nonzero(~np.isfinite(img))),
              mean_radiance=float(np.nanmean(img)))

    with log.phase("encode_write", path=args.output):
        bmp.write_bmp(args.output, bmp.encode_srgb(img))
    # the recording holds the encode too, as the multi-process one does
    if prof is not None:
        _stop_profile(prof, device, args.profile, log, "trace.json")
    return 0


def _start_profile(device):
    """A started ``torch.profiler`` recording of the CPU and, on a card,
    the device."""
    import torch
    from torch.profiler import profile

    from raytrace_tpu_torch.utils.profiling import trace_activities

    prof = profile(activities=trace_activities(device))
    prof.start()
    if device.type == "cuda":
        # a recording made after large ones loses its first device records
        # (PERF.md, §6): 64 trivial kernels go first, so that what it
        # loses is theirs and not the render's
        scratch = torch.zeros(1, device=device)
        for _ in range(64):
            scratch.add_(1.0)
    return prof


def _stop_profile(prof, device, directory: str, log, name: str) -> None:
    """Stop the recording and write it into ``directory`` as ``name``."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, name)
    prof.export_chrome_trace(path)
    log.event("profile", path=path)


if __name__ == "__main__":
    sys.exit(main())
