"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``raytrace_tpu_torch/csrc``, holds it
against its plain PyTorch version on the card, renders
``examples/cornell_indirect.txt`` at 512x512 with 16 samples per pixel
through the port's CLI on ``--device cuda`` (checking that the render
went through the kernel), and times the kernel and the plain path at
2,097,152 lanes per launch.  Every phase succeeds or raises; the last
line is ``{"ok": true, ...}`` only when all of them passed.  Without a
CUDA device it fails at once.  It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
SCENE = os.path.join(REPO, "examples", "cornell_indirect.txt")
SEED = 3

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


def pixel_lanes(width, n_pix, spp, device):
    """The lanes sample_pixels builds for the first ``n_pix`` pixels of
    an image ``width`` wide, ``spp`` samples each."""
    pix = torch.arange(n_pix, dtype=torch.int64, device=device)
    px, py = pix % width, pix // width
    sids = torch.arange(spp, dtype=torch.int64, device=device)
    return (px.repeat_interleave(spp), py.repeat_interleave(spp),
            sids.repeat(n_pix),
            torch.zeros(n_pix * spp, dtype=torch.int64, device=device))


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


def main() -> int:
    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[1] device: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.io.bmp import row_stride
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.scene.builder import load_scene_file

    # ---- phase 2: build ----
    t0 = time.perf_counter()
    _build.load(megakernel.KERNEL)
    src = os.path.join("raytrace_tpu_torch", "csrc", megakernel.KERNEL + ".cu")
    print(f"[2] built {src} with nvcc {' '.join(_build.NVCC_FLAGS)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in _build.build_logs.get(megakernel.KERNEL, "").splitlines():
        print(f"    {line}")

    # ---- phase 3: kernel vs plain version on the card ----
    scene = load_scene_file(SCENE, device=device)
    data, spec = scene.data, scene.spec
    rs = np.random.RandomState(SEED)
    n = 65536
    rand_lanes = [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
        rs.randint(0, spec.antialias, n), np.zeros(n))]
    main_lanes = pixel_lanes(spec.width, spec.width * spec.height, 16,
                             device)
    max_err = 0.0
    for name, lanes in (("random cornell lanes", rand_lanes),
                        ("the CLI's launch, 512x512 x 16 spp", main_lanes)):
        before = megakernel.LAUNCHES
        got = megakernel.radiance_lanes(data, spec, *lanes, SEED)
        want = megakernel.radiance_lanes_reference(data, spec, *lanes, SEED)
        torch.cuda.synchronize()
        if megakernel.LAUNCHES != before + 1:
            raise AssertionError("radiance_lanes did not launch the kernel")
        print(f"[3] kernel vs plain, {name}:")
        max_err = max(max_err, compare(got, want)["max_abs_err"])

    # ---- phase 4: the main path, the CLI on the card ----
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.bmp")
        log = os.path.join(tmp, "log.jsonl")
        megakernel.LAUNCHES = 0
        t0 = time.perf_counter()
        rc = cli.main([SCENE, "-o", out, "--spp", "16", "--device", "cuda",
                       "--log-json", log, "-q"])
        wall = time.perf_counter() - t0
        launches = megakernel.LAUNCHES
        if rc != 0:
            raise AssertionError(f"CLI exited {rc}")
        if launches < 1:
            raise AssertionError("the CLI render did not launch the kernel")
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
    print(f"[4] CLI render {w}x{h} x 16 spp: {wall:.2f} s wall, "
          f"{done['seconds']} s render, {launches} kernel launch(es), "
          f"mean radiance {done['mean_radiance']:.6f}, BMP {len(blob)} B")

    # ---- phase 5: throughput at 2,097,152 lanes per launch ----
    spec_b = dataclasses.replace(spec, width=1024, height=1024)
    n_s = 16
    # int32 lane ids: the wrapper passes them to the kernel as they are
    lanes = [t.to(torch.int32)
             for t in pixel_lanes(1024, (1 << 21) // n_s, n_s, device)]
    n = lanes[0].shape[0]
    rays = n * (spec_b.max_depth + 2)

    def kernel():
        megakernel.radiance_lanes(data, spec_b, *lanes, 0)

    def plain():
        megakernel.radiance_lanes_reference(data, spec_b, *lanes, 0)

    got = megakernel.radiance_lanes(data, spec_b, *lanes, 0)
    want = megakernel.radiance_lanes_reference(data, spec_b, *lanes, 0)
    print(f"[5] kernel vs plain, {n} lanes of cornell at 1024x1024:")
    max_err = max(max_err, compare(got, want)["max_abs_err"])
    # turns: plain, kernel, kernel, plain
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        fn, warm, reps = ((kernel, 3, 20) if which == "kernel"
                          else (plain, 1, 10))
        times[which].append(ms_per_launch(fn, warm, reps))
    ms = min(times["kernel"])
    plain_ms = min(times["plain"])
    for which, t in (("kernel", ms), ("plain", plain_ms)):
        print(f"    {which}: {t:.4f} ms/launch, {rays / t * 1e3:.4g} rays/s "
              f"({n} lanes x {spec_b.max_depth + 2} rounds; runs "
              f"{[round(x, 4) for x in times[which]]}) on {smi}")
    # the calls above include the wrapper's host work; the profiler
    # gives the device time of the kernels alone
    k_dev = device_ms(kernel, 20, megakernel.KERNEL)
    p_dev = device_ms(plain, 5)
    print(f"    device time per launch (torch.profiler): kernel {k_dev:.4f} "
          f"ms ({rays / k_dev * 1e3:.4g} rays/s), plain path {p_dev:.4f} ms "
          f"on {smi}")

    print(json.dumps({"kernels": [{
        "name": megakernel.KERNEL, "route": "cuda", "source": src,
        "replaces": "raytrace_tpu/render/megakernel.py:773",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
