"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's two CUDA kernels from ``raytrace_tpu_torch/csrc`` (one
nvcc each, in parallel) and holds each against its plain PyTorch version
on the card.  The linear kernel: on ``examples/cornell_indirect.txt``,
which it renders at 512x512 with 16 samples per pixel through the port's
CLI on ``--device cuda`` and times at 2,097,152 lanes per launch
(phases 3-5), and on a lit mirror scene with depth of field (phase 6).
The tree kernel: on ``examples/materials_showcase.txt``, on a
4-sample IndirectPhong scene (1,365 nodes per lane) and on two scenes
that take its two largest stack sizes (phase 7), then on the lanes of the
CLI's launch of the showcase, which the CLI then renders at its own
640x400, 64 x 4 samples per pixel (phase 8); both kernels with lights
are timed at 2,097,152 lanes per launch (phase 9).  Each CLI render checks that it went through its
kernel.  Every phase succeeds or raises; the last line is
``{"ok": true, ...}`` only when all of them passed.  Without a CUDA
device it fails at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "examples", "cornell_indirect.txt")
SHOWCASE = os.path.join(REPO, "examples", "materials_showcase.txt")
SEED = 3

# a Phong mirror floor and a Phong sphere under a point and a directional
# light, through a depth-of-field camera: one child slot, the linear kernel
LIT_MIRROR = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8
        ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }
  ]
  lights: [
    { model: PointLight { location: (2, 3, -1) } color: rgb(1.2,1.1,1.0) }
    { model: DirectionalLight { direction: (0, -1, -0.2) }
      color: rgb(0.3, 0.3, 0.35) }
  ]
  camera: DepthOfFieldCamera new(
    new((0,0,0), (0,0,-1), (0,1,0), 2),
    4.0, 0.05, 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 512 height: 512 antialias: 16 }
}"""
# the same floor beside a 4-sample IndirectPhong sphere: m = 4, 1,365 DFS
# nodes per lane at max_depth 4
INDIRECT4 = LIT_MIRROR.replace(
    """material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }""",
    """material: IndirectPhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0.2,0.2,0.2)
        samples: 4 } }""")
# (IndirectPhong samples, max_depth) of the scenes whose DFS stacks take
# the tree kernel's two largest stack sizes: 22 entries (of 32) and 47 (of
# 64), at 585 and 601 nodes per lane
DEEP_STACKS = ((8, 2), (24, 1))

# kernel vs plain version: Monte-Carlo paths fork after a near-tie when
# two roundings differ by an ulp, so a few lanes may disagree by a lot;
# the JAX package misses the per-lane rule against itself by 0.3% of lanes
LANE_RTOL = 1e-4          # |d| <= LANE_RTOL * max(1, |ref|) per channel
MIN_LANES_OK = 0.99       # ... on at least this share of the lanes
MEAN_RTOL = 1e-3          # per-channel means


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def compare(got, want) -> dict:
    """Hold kernel radiance against the plain version's; raise if the
    tolerance above is missed."""
    g = torch.stack(list(got)).double().cpu().numpy()
    w = torch.stack(list(want)).double().cpu().numpy()
    d = np.abs(g - w)
    lanes_ok = (d <= LANE_RTOL * np.maximum(1.0, np.abs(w))).all(axis=0)
    mean_rel = np.abs(g.mean(1) - w.mean(1)) / np.abs(w.mean(1))
    stats = {"lanes": g.shape[1],
             "share_outside": float(1.0 - lanes_ok.mean()),
             "bit_equal": float((g == w).all(axis=0).mean()),
             "max_abs_err": float(d.max()),
             "mean_rel_diff": [float(x) for x in mean_rel],
             "finite": bool(np.isfinite(g).all())}
    print(f"  {stats}")
    if not (stats["finite"] and lanes_ok.mean() >= MIN_LANES_OK
            and (mean_rel <= MEAN_RTOL).all()):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"{stats}")
    return stats


def pixel_lanes(width, n_pix, spp, cam_samples, device):
    """The lanes sample_pixels sends for the first ``n_pix`` pixels of
    an image ``width`` wide: aa samples 0..spp-1 of each, each with
    ``cam_samples`` lens samples."""
    from raytrace_tpu_torch.render.integrator import lane_ids

    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    return lane_ids(pix % width, pix // width,
                    torch.arange(spp, dtype=torch.int64, device=device),
                    cam_samples)


def ms_per_launch(fn, warmup: int, reps: int) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, name_part: str = "") -> float:
    """Device time per call of the CUDA kernels and copies whose name
    contains ``name_part``, from torch.profiler over ``reps`` calls.
    Only device rows count: a CPU operator's row repeats the device time
    of the kernels it launched."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and name_part in e.key)
    if us <= 0:
        raise AssertionError(f"the profiler saw no device time for "
                             f"{name_part or 'any kernel'}")
    return us / 1e3 / reps


def random_lanes(spec, n, seed, device):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
        rs.randint(0, max(spec.antialias, 1), n),
        rs.randint(0, spec.cam_samples, n))]


def check_kernel(megakernel, kernel, data, spec, lanes, seed, label) -> dict:
    """One wrapper call on the card, which must launch ``kernel`` once
    and nothing else, held against the plain version on the same lanes."""
    if megakernel.kernel_for(spec) != kernel:
        raise AssertionError(f"{label}: the scene is not {kernel}'s")
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(data, spec, *lanes, seed)
    torch.cuda.synchronize()
    rose = {k: megakernel.LAUNCHES[k] - before[k] for k in megakernel.KERNELS}
    if rose != {k: int(k == kernel) for k in megakernel.KERNELS}:
        raise AssertionError(f"{label}: launches {rose}, not one of {kernel}")
    want = megakernel.radiance_lanes_reference(data, spec, *lanes, seed)
    torch.cuda.synchronize()
    print(f"    {kernel} vs plain, {label}:")
    return compare(got, want)


def cli_render(cli, megakernel, kernel, scene_path, args, spec):
    """The CLI on --device cuda, with the launch counts set to 0 just
    before it; checks the BMP and the image.  Returns (render_done log
    record, wall seconds, launches per kernel)."""
    from raytrace_tpu_torch.io.bmp import row_stride

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.bmp")
        log = os.path.join(tmp, "log.jsonl")
        for k in megakernel.KERNELS:
            megakernel.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        rc = cli.main([scene_path, "-o", out, *args, "--device", "cuda",
                       "--log-json", log, "-q"])
        wall = time.perf_counter() - t0
        launches = dict(megakernel.LAUNCHES)
        if rc != 0:
            raise AssertionError(f"CLI exited {rc}")
        if launches[kernel] < 1:
            raise AssertionError(f"the CLI render did not launch {kernel}")
        with open(out, "rb") as f:
            blob = f.read()
        with open(log) as f:
            done = [json.loads(x) for x in f if '"render_done"' in x][-1]
    w, h = struct.unpack("<ii", blob[18:26])
    if not (blob[:2] == b"BM" and blob[0x46:0x4A] == b"BGRs"
            and (w, h) == (spec.width, spec.height)
            and len(blob) == 122 + row_stride(w) * h):
        raise AssertionError("the CLI wrote a malformed BMP")
    if done["nonfinite"] != 0 or not done["mean_radiance"] > 0:
        raise AssertionError(f"bad image: {done}")
    return done, wall, launches, len(blob)


def time_pair(kernel, plain, k_reps: int, p_reps: int):
    """ms per call of the kernel's wrapper and of the plain version, in
    turns plain, kernel, kernel, plain; the best of each."""
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, warm, reps = ((kernel, 3, k_reps) if which == "kernel"
                          else (plain, 1, p_reps))
        times[which].append(ms_per_launch(fn, warm, reps))
    return min(times["kernel"]), min(times["plain"]), times


def main() -> int:
    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[1] device: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.render.integrator import (_s_p_launch,
                                                      tree_loop_stack)
    from raytrace_tpu_torch.scene import dsl
    from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file

    k_lin, k_tree = megakernel.KERNEL_LINEAR, megakernel.KERNEL_TREE
    srcs = {k: os.path.join("raytrace_tpu_torch", "csrc", k + ".cu")
            for k in megakernel.KERNELS}

    # ---- phase 2: build, one nvcc per kernel, all started together ----
    t0 = time.perf_counter()
    errors = []

    def build(name):
        try:
            _build.load(name)
        except Exception as e:  # re-raised below, after every build ended
            errors.append(e)

    threads = [threading.Thread(target=build, args=(k,))
               for k in megakernel.KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    print(f"[2] built {', '.join(srcs.values())} with nvcc "
          f"{' '.join(_build.NVCC_FLAGS)} in {time.perf_counter() - t0:.2f} s")
    for k in megakernel.KERNELS:
        for line in _build.build_logs.get(k, "").splitlines():
            inst = re.search(r"(megakernel_\w+?)IL[bi](\d+)E", line)
            if "entry function" in line and inst:
                print(f"    {inst.group(1)}<{inst.group(2)}>:")
            elif "registers" in line or "stack frame" in line:
                print(f"      {line.strip()}")
    max_err = {k: 0.0 for k in megakernel.KERNELS}

    # ---- phase 3: the linear kernel vs plain version on the card ----
    scene = load_scene_file(SCENE, device=device)
    data, spec = scene.data, scene.spec
    rand_lanes = random_lanes(spec, 65536, SEED, device)
    main_lanes = pixel_lanes(spec.width, spec.width * spec.height, 16, 1,
                             device)
    print("[3] kernel vs plain on cornell_indirect:")
    for name, lanes in (("random cornell lanes", rand_lanes),
                        ("the CLI's launch, 512x512 x 16 spp", main_lanes)):
        stats = check_kernel(megakernel, k_lin, data, spec, lanes, SEED, name)
        max_err[k_lin] = max(max_err[k_lin], stats["max_abs_err"])

    # ---- phase 4: the main path, the CLI on the card ----
    done, wall, launches, size = cli_render(cli, megakernel, k_lin, SCENE,
                                            ["--spp", "16"], spec)
    lin_launches = launches[k_lin]
    print(f"[4] CLI render {spec.width}x{spec.height} x 16 spp: {wall:.2f} s "
          f"wall, {done['seconds']} s render, launches {launches}, mean "
          f"radiance {done['mean_radiance']:.6f}, BMP {size} B")

    # ---- phase 5: throughput at 2,097,152 lanes per launch ----
    spec_b = dataclasses.replace(spec, width=1024, height=1024)
    n_s = 16
    # int32 lane ids: the wrapper passes them to the kernel as they are
    lanes = [t.to(torch.int32)
             for t in pixel_lanes(1024, (1 << 21) // n_s, n_s, 1, device)]
    n = lanes[0].shape[0]
    rays = n * (spec_b.max_depth + 2)

    def kernel():
        megakernel.radiance_lanes(data, spec_b, *lanes, 0)

    def plain():
        megakernel.radiance_lanes_reference(data, spec_b, *lanes, 0)

    print(f"[5] {n} lanes of cornell at 1024x1024:")
    stats = check_kernel(megakernel, k_lin, data, spec_b, lanes, 0,
                         "1024x1024 x 16 spp")
    max_err[k_lin] = max(max_err[k_lin], stats["max_abs_err"])
    ms, plain_ms, times = time_pair(kernel, plain, 20, 10)
    for which, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"    {which}: {t:.4f} ms/launch, {rays / t * 1e3:.4g} rays/s "
              f"({n} lanes x {spec_b.max_depth + 2} rounds; runs "
              f"{[round(x, 4) for x in times[which]]}) on {smi}")
    # the calls above include the wrapper's host work; the profiler
    # gives the device time of the kernels alone
    k_dev = device_ms(kernel, 20, k_lin)
    p_dev = device_ms(plain, 5)
    print(f"    device time per launch (torch.profiler): kernel {k_dev:.4f} "
          f"ms ({rays / k_dev * 1e3:.4g} rays/s), plain path {p_dev:.4f} ms "
          f"on {smi}")
    timing = {k_lin: (ms, plain_ms)}

    # ---- phase 6: the linear kernel with lights, mirror and DoF ----
    lit = build_scene(dsl.parse(LIT_MIRROR), device=device)
    print("[6] kernel vs plain on the lit mirror scene (point and "
          "directional lights, Phong mirror, depth of field):")
    stats = check_kernel(megakernel, k_lin, lit.data, lit.spec,
                         random_lanes(lit.spec, 65536, SEED, device), SEED,
                         "65,536 random lanes")
    max_err[k_lin] = max(max_err[k_lin], stats["max_abs_err"])

    # ---- phase 7: the tree kernel vs plain version ----
    show = load_scene_file(SHOWCASE, device=device)
    ind4 = build_scene(dsl.parse(INDIRECT4), device=device)
    deep = []
    for samples, depth in DEEP_STACKS:
        sc = build_scene(dsl.parse(INDIRECT4.replace(
            "samples: 4", f"samples: {samples}")), device=device)
        deep.append((f"{samples}-sample IndirectPhong at max_depth {depth}, "
                     f"4,096 random lanes",
                     dataclasses.replace(sc, spec=dataclasses.replace(
                         sc.spec, max_depth=depth)), 4096))
    print("[7] tree kernel vs plain:")
    for label, sc, n in (("materials_showcase, 65,536 random lanes", show,
                          65536),
                         ("4-sample IndirectPhong, 16,384 random lanes",
                          ind4, 16384), *deep):
        m, levels, nodes, cap = tree_loop_stack(sc.spec)
        print(f"    {label}: m={m}, {levels} levels, {nodes} nodes, "
              f"stack {cap}")
        t0 = time.perf_counter()
        stats = check_kernel(megakernel, k_tree, sc.data, sc.spec,
                             random_lanes(sc.spec, n, SEED, device), SEED,
                             label)
        print(f"    ({time.perf_counter() - t0:.2f} s)")
        max_err[k_tree] = max(max_err[k_tree], stats["max_abs_err"])

    # ---- phase 8: the showcase through the CLI at its own settings ----
    s = show.spec
    # the lanes of the CLI's first launch: every pixel, the first s_launch
    # aa samples, each with every lens sample
    s_launch, p_launch = _s_p_launch(s, s.antialias, 1 << 22)
    if p_launch != s.width * s.height:
        raise AssertionError("the showcase no longer fits one launch")
    print(f"[8] the CLI's launch, {s.width}x{s.height} x {s_launch} aa x "
          f"{s.cam_samples} lens samples:")
    t0 = time.perf_counter()
    stats = check_kernel(megakernel, k_tree, show.data, s,
                         pixel_lanes(s.width, p_launch, s_launch,
                                     s.cam_samples, device), SEED,
                         "the CLI's launch")
    print(f"    ({time.perf_counter() - t0:.2f} s)")
    max_err[k_tree] = max(max_err[k_tree], stats["max_abs_err"])
    done, wall, launches, size = cli_render(cli, megakernel, k_tree, SHOWCASE,
                                            [], s)
    tree_launches = launches[k_tree]
    print(f"    CLI render of materials_showcase {s.width}x{s.height} x "
          f"{s.antialias} aa x {s.cam_samples} lens samples: {wall:.2f} s "
          f"wall, {done['seconds']} s render, launches {launches}, mean "
          f"radiance {done['mean_radiance']:.6f}, BMP {size} B, on {smi}")

    # ---- phase 9: the lit kernels at 2,097,152 lanes per launch ----
    print("[9] 2,097,152 lanes per launch:")
    for kname, label, sc, k_reps, p_reps in (
            (k_tree, "tree kernel, materials_showcase", show, 10, 2),
            (k_lin, "linear kernel, lit mirror scene", lit, 20, 5)):
        lanes = [t.to(torch.int32)
                 for t in random_lanes(sc.spec, 1 << 21, SEED, device)]

        def kernel():
            megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 0)

        def plain():
            megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes, 0)

        stats = check_kernel(megakernel, kname, sc.data, sc.spec, lanes, 0,
                             label)
        max_err[kname] = max(max_err[kname], stats["max_abs_err"])
        ms, plain_ms, times = time_pair(kernel, plain, k_reps, p_reps)
        k_dev = device_ms(kernel, k_reps, kname)
        p_dev = device_ms(plain, 1)
        print(f"    {label}: kernel {ms:.4f} ms/call (runs "
              f"{[round(x, 4) for x in times['kernel']]}), {k_dev:.4f} ms on "
              f"the device; plain {plain_ms:.4f} ms/call (runs "
              f"{[round(x, 4) for x in times['plain']]}), {p_dev:.4f} ms on "
              f"the device; on {smi}")
        if kname == k_tree:
            timing[k_tree] = (ms, plain_ms)

    launches = {k_lin: lin_launches, k_tree: tree_launches}
    # the one pallas_call: its linear regime, and its fan-out regime
    # (radiance_tree_v traced in _kernel, :424, and _tree_loop_scratch,
    # :509)
    replaces = {k: "raytrace_tpu/render/megakernel.py:773"
                for k in megakernel.KERNELS}
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k],
        "replaces": replaces[k],
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": timing[k][0], "plain_ms": timing[k][1]}
        for k in megakernel.KERNELS]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
