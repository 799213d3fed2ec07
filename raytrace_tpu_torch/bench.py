"""Benchmark harness of the port: rays per second on the golden path.

PyTorch counterpart of the JAX package's ``bench.py``, with its three
modes, its flags, its metric names and its keys:

    python3 -m raytrace_tpu_torch.bench [--scene PATH] [--lanes N]
    python3 -m raytrace_tpu_torch.bench --large N [--mix]
    python3 -m raytrace_tpu_torch.bench --shard

and ``--device {cuda,cpu}`` (default ``cuda``; without a CUDA device
``cuda`` is an error, never a CPU run).  Each mode prints one JSON line.

**Workload.**  The golden regime at 1024x1024, 16 samples per pixel and
2,097,152 lanes a launch on the card (65,536 on the CPU): by default
``examples/cornell_indirect.txt`` (5 planes, 2 spheres, IndirectPhong, no
lights), since the reference snapshot's ``test_scene.txt`` that
``bench.py`` reads is not part of the repository; ``--scene`` takes it
where it exists.  A launch is one :func:`sample_pixels` call, so K1's
wrapper and the sampler's lane identities and per-pixel mean.  One ray is
one closest-hit round: ``primary x (max_depth + 2)``, or on a fan-out
scene ``primary x tree_nodes``.  ``vs_baseline`` is against
``REF_CPU_RAYS_PER_SEC``, ``bench.py``'s anchor (the reference renderer's
single-thread throughput, measured by ``native/ref_anchor.cpp``).

**Method** (:func:`measure_slope`, ``bench.py::_measure_slope``'s): a
chain of k launches, each on pixels shifted by the launch's index and a
bias fresh for every timed call, summed into one scalar on the device,
one synchronise at its end; each call timed by CUDA events on the card
(by the host's clock on the CPU); the reps of every k interleaved; the
least-squares line through the medians over k = 4, 16, 64: its slope is
the marginal time of a launch, its intercept the chain's fixed cost.  On
the card also the share of one k = 16 chain that the device was busy,
from ``torch.profiler``, over such a chain's span without the profiler:
when it is well under 1 the host's launches set the pace, not the
kernels.  The ids are 32-bit, as ``bench.py``'s (uint32) are.

``--large N`` builds ``make_sphere_field(N, mix_materials=--mix)`` (N
spheres in a box: 1000 gives the 1,006-object field) and times two
chains on it: *fused*, the large instance of K1 or K3 folding over the
scene's table, and *split*, the same lanes through
``megakernel.radiance_lanes_split`` (the scan kernel K5 plus the ring
kernels).  On the card each chain's launch counts must show it: the fused
chain moves the render kernel's count and not K5's, the split chain K5's
and not the render kernel's.

``--shard`` is weak scaling over the ranks of the process group
(``parallel/mesh.py::maybe_init_distributed``'s environment protocol;
one rank without it): every rank runs the single-rank launch on its own
pixels and the chain's scalar is summed over the ranks at its end;
efficiency is the single-rank slope (rank 0 alone, the others waiting)
over the sharded slope.  Ranks that share one device (the one-card host,
gloo on the CPU) can reach at most 1/n of it, which
``efficiency_vs_backend_ceiling`` divides out.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

# the golden regime's scene in the repository (examples/ beside the package)
CORNELL = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "cornell_indirect.txt")

# bench.py's anchor: the reference renderer's single-thread throughput,
# scene intersections per second (native/ref_anchor.cpp, BASELINE.md)
REF_CPU_RAYS_PER_SEC = 8.5e6

# bench.py's chain lengths and interleaved reps
KS, REPS = (4, 16, 64), 5
# the chain whose device-busy share is read
BUSY_K = 16
# the least warm-up, in seconds: chains timed at once after an idle spell
# of the process have read up to a quarter slower than later ones of the
# same process
WARM_S = 1.0
# the golden workload: image size, samples per pixel, lanes a launch
SIZE = 1024
SAMPLES = 16
LANES = {"cuda": 1 << 21, "cpu": 1 << 16}


class Slope(NamedTuple):
    """What :func:`measure_slope` reads of a chain."""

    per_launch_ms: float        # the least-squares slope over k
    fixed_ms: float             # its intercept: the chain's fixed cost
    times_ms: dict              # k -> each timed call's ms
    device_busy: float | None   # a BUSY_K chain's device time over its span


def _time_call(chain, k: int, bias: int, on_card: bool) -> float:
    """ms of one ``chain(k, bias)`` call, to its end on the device."""
    if on_card:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(k, bias)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    chain(k, bias)
    return (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def _collector_paused():
    """Python's cyclic garbage collector paused, as ``timeit`` pauses it:
    its pauses come from the whole process's objects, not from the timed
    launches."""
    gc.collect()
    paused = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if paused:
            gc.enable()


def device_busy(chain, bias: int = 0) -> float:
    """The share of a ``chain(BUSY_K, ...)`` call on the card that the
    device spent in kernels and copies: their time under the profiler
    (``utils/profiling.py::device_busy_ms``) over the median span of three
    such calls without it, whose own host work would stretch the span.
    A recording may slow the process's later launches, so a run takes its
    slopes first."""
    from raytrace_tpu_torch.utils.profiling import device_busy_ms

    with _collector_paused():
        spans = [_time_call(chain, BUSY_K, bias + i, True) for i in (1, 2, 3)]
    return (device_busy_ms(lambda: chain(BUSY_K, bias + 4))
            / float(np.median(spans)))


def measure_slope(chain, ks=KS, reps=REPS, mesh=None,
                  busy: bool = True) -> Slope:
    """Least-squares slope and intercept (ms) of the median time of
    ``chain(k, bias)`` over the chain lengths ``ks``, with each timed
    call's ms and, on the card with ``busy``, :func:`device_busy`.

    ``chain(k, bias)`` enqueues k launches whose inputs differ by launch
    and by ``bias``, and returns a tensor of the device it ran on, which
    picks the clock: CUDA events on a card, the host's otherwise.  The
    warm-up lasts ``WARM_S`` at least; where the chain is one of the ranks
    of ``mesh`` together, they agree on the longest any of them wants, so
    that each makes the same calls.  Every timed call gets a fresh bias;
    the reps of all the k interleave, so that drift touches every k alike;
    the garbage collector is paused while they run."""
    from raytrace_tpu_torch.parallel.mesh import all_reduce_max

    t0 = time.perf_counter()
    outs = [chain(k, 0) for k in ks]   # warm: builds, caches, the pool
    on_card = outs[-1].device.type == "cuda"
    del outs
    while True:
        if on_card:
            torch.cuda.synchronize()
        more = time.perf_counter() - t0 < WARM_S
        if not (all_reduce_max(more, mesh) if mesh is not None else more):
            break
        chain(ks[-1], 0)
    times = {k: [] for k in ks}
    bias = 0
    with _collector_paused():
        for _ in range(reps):
            for k in ks:
                bias += 1
                times[k].append(_time_call(chain, k, bias, on_card))
    a = np.array([[k, 1.0] for k in ks])
    y = np.array([float(np.median(times[k])) for k in ks])
    (per_launch, fixed), *_ = np.linalg.lstsq(a, y, rcond=None)
    return Slope(float(per_launch), float(fixed), times,
                 device_busy(chain, bias) if busy and on_card else None)


def make_chain(data, spec, px, py, sids, radiance=None, mesh=None):
    """``chain(k, bias)`` for :func:`measure_slope`: k
    :func:`sample_pixels` launches (through ``radiance``, by default
    ``megakernel.radiance_lanes``) on the pixels ``((px + bias + i) %
    width, py)``, summed into one (1,) tensor on the device; with ``mesh``
    it is then summed over its ranks.  The shifted pixels are made for the
    whole chain before its first launch and the outputs summed after its
    last, as one program does where ``bench.py``'s loop runs under jit, so
    that the slope is the launches' alone."""
    from raytrace_tpu_torch.parallel.mesh import all_reduce_sum_
    from raytrace_tpu_torch.render.integrator import sample_pixels

    def chain(k: int, bias: int) -> torch.Tensor:
        shift = torch.arange(bias, bias + k, dtype=px.dtype, device=px.device)
        outs = [sample_pixels(data, spec, x, py, sids, 0, radiance=radiance)
                for x in ((px + shift[:, None]) % spec.width).unbind(0)]
        acc = torch.cat(outs).sum().reshape(1)
        return acc if mesh is None else all_reduce_sum_(acc, mesh)

    return chain


def ray_counts(spec, n_pix: int, n_s: int) -> dict:
    """``bench.py``'s counts for a launch of ``n_pix`` pixels of ``n_s``
    samples: primary rays, closest-hit levels of a linear chain, rounds a
    primary ray takes (the tree's nodes on a fan-out scene, whose lanes
    visit the same node set in both regimes), and the scene's objects."""
    from raytrace_tpu_torch.render.integrator import tree_nodes

    levels = spec.max_depth + 2
    return {"primary": n_pix * n_s * spec.cam_samples, "levels": levels,
            "rounds": (tree_nodes(spec) if spec.children_per_ray > 1
                       else levels),
            "objects": sum(1 for t in spec.shape_type if t >= 0)}


def pixels(n_pix: int, device, first: int = 0):
    """(px, py) of ``n_pix`` pixels of the 1024x1024 image in row order
    from pixel ``first``, as 32-bit ids (``bench.py``'s are uint32; the
    kernels take 32-bit words as they come)."""
    pix = torch.arange(first, first + n_pix, dtype=torch.int32,
                       device=device)
    return pix % SIZE, (pix // SIZE) % SIZE


def card(device) -> str:
    """Where the numbers were taken: the card's name and power limit, or
    ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    from raytrace_tpu_torch.utils.gpu_info import nvidia_smi
    return nvidia_smi()


def _launch_moves(fn):
    """(fn's result, how far it moved each kernel's launch count)."""
    from raytrace_tpu_torch.ops import _build

    before = dict(_build.LAUNCHES)
    out = fn()
    return out, {k: v - before[k] for k, v in _build.LAUNCHES.items()}


def large_mode(n: int, mix: bool, px, py, sids, device, ks, reps) -> dict:
    """``--large N [--mix]``: the fused and the split chains on the
    N-sphere field, ``bench.py``'s keys (:191-201)."""
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    sc = make_sphere_field(n, mix_materials=mix, device=device)
    data, spec = sc.data, sc.spec
    chain_f = make_chain(data, spec, px, py, sids)
    chain_s = make_chain(data, spec, px, py, sids,
                         radiance=megakernel.radiance_lanes_split)
    # both slopes before either recording
    fused, moved_f = _launch_moves(
        lambda: measure_slope(chain_f, ks, reps, busy=False))
    split, moved_s = _launch_moves(
        lambda: measure_slope(chain_s, ks, reps, busy=False))
    on_card = device.type == "cuda"
    if on_card:
        render, scan = megakernel.kernel_for(spec), megakernel.KERNEL_SCAN
        if not (moved_f[render] > 0 and moved_f[scan] == 0
                and moved_s[scan] > 0 and moved_s[render] == 0):
            raise RuntimeError(
                f"the chains did not run their kernels: fused {moved_f}, "
                f"split {moved_s}")
    c = ray_counts(spec, px.shape[0], sids.shape[0])
    rays = c["primary"] * c["rounds"]
    t_f, t_s = fused.per_launch_ms, split.per_launch_ms
    return {
        "metric": (f"large_scene_fused_vs_split_{c['objects']}obj_"
                   f"{'mix' if mix else 'linear'}"),
        "value": round(rays / t_f * 1e3),
        "unit": "rays/s",
        "vs_baseline": t_s / t_f,
        "fused_launch_ms": t_f,
        "split_launch_ms": t_s,
        "speedup_fused_over_split": t_s / t_f,
        "obj_tests_per_sec_fused": round(rays * c["objects"] / t_f * 1e3),
        "scene": f"make_sphere_field({n}, mix_materials={mix})",
        "card": card(device),
        "device_busy_fused": device_busy(chain_f) if on_card else None,
        "device_busy_split": device_busy(chain_s) if on_card else None,
    }


def shard_mode(single: Slope | None, data, spec, n_pix, sids, device,
               ks, reps, scene: str) -> dict | None:
    """``--shard``: the sharded chain on every rank; rank 0's line
    (``bench.py``'s keys, :253-265), None on the other ranks."""
    import torch.distributed as dist

    from raytrace_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device)
    n = mesh.ranks
    if n > 1:
        dist.barrier()   # until rank 0 has its single-rank slope
    px, py = pixels(n_pix, device, first=mesh.rank * n_pix)
    sharded = measure_slope(make_chain(data, spec, px, py, sids, mesh=mesh),
                            ks, reps, mesh, busy=False)
    if mesh.rank != 0:
        return None
    eff = single.per_launch_ms / sharded.per_launch_ms
    shared = device.type == "cpu" or torch.cuda.device_count() < n
    ceiling = 1.0 / n if shared else 1.0
    c = ray_counts(spec, n_pix, sids.shape[0])
    total = c["primary"] * c["levels"] * n / sharded.per_launch_ms * 1e3
    return {
        "metric": f"scaling_efficiency_weak_{n}dev",
        "value": eff,
        "unit": "fraction",
        "vs_baseline": eff / ceiling,
        "efficiency_vs_backend_ceiling": eff / ceiling,
        "n_devices": n,
        "backend": device.type,
        "rays_per_sec_per_device": round(total / n),
        "rays_per_sec_total": round(total),
        "single_device_launch_ms": single.per_launch_ms,
        "sharded_launch_ms": sharded.per_launch_ms,
        "scene": scene,
        "card": card(device),
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="raytrace_tpu_torch.bench",
        description="rays per second of the port on the golden path")
    ap.add_argument("--shard", action="store_true",
                    help="weak-scaling efficiency over the process group's "
                         "ranks")
    ap.add_argument("--lanes", type=int, default=None,
                    help="lanes per rank per launch (default: 2,097,152 on "
                         "cuda, 65,536 on cpu)")
    ap.add_argument("--large", type=int, default=None, metavar="N",
                    help="bench an N-sphere procedural field instead of "
                         "the golden scene: fused (the large render "
                         "kernels) vs split (the scan kernel and the ring "
                         "kernels)")
    ap.add_argument("--mix", action="store_true",
                    help="with --large: mixed materials (a fan-out scene, "
                         "the tree kernel)")
    ap.add_argument("--scene", default=CORNELL,
                    help="the golden regime's scene file (default: "
                         "examples/cornell_indirect.txt)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device to measure (default: cuda)")
    return ap


def main(argv=None, ks=KS, reps=REPS) -> int:
    """Run the mode ``argv`` asks for and print its line (rank 0's, under
    ``--shard``); ``ks`` and ``reps`` are the chain lengths and reps of
    every slope."""
    args = build_parser().parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but PyTorch sees no CUDA device",
              file=sys.stderr)
        return 1
    from raytrace_tpu_torch.parallel import mesh as meshlib
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.dsl import SceneSyntaxError

    # multi-process bring-up before any other device query; a no-op
    # unless the environment configures a process group
    meshlib.maybe_init_distributed(args.device)
    device = (meshlib.rank_device(meshlib.process_index())
              if args.device == "cuda" else torch.device("cpu"))
    lanes = args.lanes or LANES[device.type]
    n_pix = max(lanes // SAMPLES, 1)
    px, py = pixels(n_pix, device)
    sids = torch.arange(SAMPLES, dtype=torch.int32, device=device)

    with torch.no_grad():
        if args.large:
            line = large_mode(args.large, args.mix, px, py, sids, device, ks,
                              reps)
        else:
            try:
                sc = load_scene_file(args.scene, device=device)
            except (OSError, SceneSyntaxError) as e:
                print(f"error: {e}", file=sys.stderr)
                return 1
            spec = dataclasses.replace(sc.spec, width=SIZE, height=SIZE)
            scene = os.path.basename(args.scene)
            # the single-rank slope; under --shard rank 0's alone, as on
            # one device of the mesh, and no recording before the sharded
            # slope
            alone = not args.shard or meshlib.process_index() == 0
            single = (measure_slope(make_chain(sc.data, spec, px, py, sids),
                                    ks, reps, busy=not args.shard)
                      if alone else None)
            if args.shard:
                line = shard_mode(single, sc.data, spec, n_pix, sids, device,
                                  ks, reps, scene)
            else:
                c = ray_counts(spec, n_pix, SAMPLES)
                rays_per_s = (c["primary"] * c["levels"]
                              / single.per_launch_ms * 1e3)
                line = {
                    "metric": "rays_per_sec_per_chip_1024sq_depth4",
                    "value": round(rays_per_s),
                    "unit": "rays/s",
                    "vs_baseline": rays_per_s / REF_CPU_RAYS_PER_SEC,
                    "per_launch_ms": single.per_launch_ms,
                    "fixed_overhead_ms": single.fixed_ms,
                    "scene": scene,
                    "card": card(device),
                    "device_busy": single.device_busy,
                }
    if line is not None:
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
