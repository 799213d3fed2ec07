"""Which rounding forks the lanes of the port's render kernels?

    python3 tools/torch_fork_search.py [--lanes N]

Runs on one NVIDIA GPU.  Builds variants of the port's CUDA kernels from
patched copies of ``raytrace_tpu_torch/csrc`` (the sources in the tree
are not touched) and holds each against the plain PyTorch path on the
scene of ``tests/test_torch_megakernel.py::
test_tree_kernel_deep_stacks_on_card[24-1]`` (a 24-sample IndirectPhong
sphere over a Phong floor at max_depth 1: 601 nodes per lane), on the
test's own 2,048 lanes (seed 10) and on ``--lanes`` random ones, and the
linear kernel on cornell_indirect's 4,194,304-lane CLI launch (512x512 x
16 spp, seed 3).  For each variant it prints the share of lanes outside
the per-lane rule
(``|d| <= 1e-4 * max(1, |ref|)``), the ptxas registers, and the time per
2,097,152-lane launch on cornell_indirect (the linear kernel's lean
instance) and on materials_showcase (the tree kernel), so that a cure's
cost stands beside its effect.

The variants replace contracted multiply-adds by separately rounded
products and sums (as the plain path computes them) in more and more of
the device code: nothing (every kernel contracted), the hit record and
child origins of ``shade_node``, also the object tests, also the primary
ray, everything (``-fmad=false`` on every kernel), and last the tree as it
is (``ops/_build.py::KERNEL_FLAGS``).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import re
import sys
import tempfile

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (old, new) replacements in render_common.cuh and the two megakernel
# sources, cumulative from one variant to the next; each must occur
RN_SHADE = [("constexpr bool RN = LARGE != 0;", "constexpr bool RN = true;")]
RN_TESTS = RN_SHADE + [
    ("const float b = 2.0f * dot_<false>(dx, dy, dz, ocx, ocy, ocz);",
     "const float b = 2.0f * dot_<true>(dx, dy, dz, ocx, ocy, ocz);"),
    ("const float cc = dot_<false>(ocx, ocy, ocz, ocx, ocy, ocz) - rr;",
     "const float cc = __fsub_rn(dot_<true>(ocx, ocy, ocz, ocx, ocy, ocz), rr);"),
    ("const float disc = b * b - a4 * cc;",
     "const float disc = __fsub_rn(__fmul_rn(b, b), __fmul_rn(a4, cc));"),
    ("plane_t<false>(", "plane_t<true>("),
    ("const float a = dx * dx + dy * dy + dz * dz;",
     "const float a = dot_<true>(dx, dy, dz, dx, dy, dz);"),
]
RN_PRIMARY = RN_TESTS + [("primary_ray<LARGE != 0>(", "primary_ray<true>(")]
# (name, edits, flags of every kernel beside the common ones; None: the
# per-kernel flags of ops/_build.py, the tree as it is)
VARIANTS = (("contracted everywhere", [], ()),
            ("shade_node RN", RN_SHADE, ()),
            ("+ object tests RN", RN_TESTS, ()),
            ("+ primary ray RN", RN_PRIMARY, ()),
            ("-fmad=false, every kernel", [], ("-fmad=false",)),
            ("as it is", [], None))


def patched_sources(src_dir: str, dst_dir: str, edits) -> None:
    os.makedirs(dst_dir)
    texts = {}
    for name in os.listdir(src_dir):
        with open(os.path.join(src_dir, name)) as f:
            texts[name] = f.read()
    for old, new in edits:
        if not any(old in t for t in texts.values()):
            raise AssertionError(f"the sources no longer hold {old!r}")
        texts = {k: t.replace(old, new) for k, t in texts.items()}
    for name, text in texts.items():
        with open(os.path.join(dst_dir, name), "w") as f:
            f.write(text)


def share_outside(got, want) -> tuple[float, float]:
    g = torch.stack(list(got)).double()
    w = torch.stack(list(want)).double()
    d = (g - w).abs()
    ok = (d <= 1e-4 * torch.clamp(w.abs(), min=1.0)).all(dim=0)
    return float(1.0 - ok.double().mean()), float((d == 0).all(dim=0)
                                                  .double().mean())


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=32768)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)

    import chip_smoke

    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.scene import dsl
    from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file

    smi = chip_smoke.nvidia_smi()
    print(f"device: {smi}")
    # the test's scene: chip_smoke's lit mirror scene at 32x32 with the
    # sphere a 24-sample IndirectPhong of ambient 1
    text = chip_smoke.INDIRECT4.replace(
        "ambient: rgb(0.2,0.2,0.2)\n        samples: 4",
        "ambient: rgb(1,1,1)\n        samples: 24").replace(
        "width: 512 height: 512 antialias: 16",
        "width: 32 height: 32 antialias: 2")
    if "samples: 24" not in text or "width: 32" not in text:
        raise AssertionError("the scene text no longer matches")
    sc = build_scene(dsl.parse(text), device=device)
    spec = dataclasses.replace(sc.spec, max_depth=1)
    rs = np.random.RandomState(10)
    test_lanes = [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, 32, 2048), rs.randint(0, 32, 2048),
        rs.randint(0, 2, 2048), rs.randint(0, 2, 2048))]
    rs = np.random.RandomState(11)
    more_lanes = [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, 32, args.lanes), rs.randint(0, 32, args.lanes),
        rs.randint(0, 1 << 20, args.lanes), rs.randint(0, 2, args.lanes))]
    want_test = megakernel.radiance_lanes_reference(sc.data, spec,
                                                    *test_lanes, 10)
    want_more = megakernel.radiance_lanes_reference(sc.data, spec,
                                                    *more_lanes, 10)

    cornell = load_scene_file(chip_smoke.SCENE, device=device)
    launch = chip_smoke.pixel_lanes(512, 512 * 512, 16, 1, device)
    want_launch = megakernel.radiance_lanes_reference(cornell.data,
                                                      cornell.spec, *launch, 3)
    spec_c = dataclasses.replace(cornell.spec, width=1024, height=1024)
    lanes_c = [t.to(torch.int32) for t in chip_smoke.pixel_lanes(
        1024, (1 << 21) // 16, 16, 1, device)]
    show = load_scene_file(chip_smoke.SHOWCASE, device=device)
    lanes_s = [t.to(torch.int32) for t in chip_smoke.random_lanes(
        show.spec, 1 << 21, 3, device)]

    src_dir, flags = _build.CSRC_DIR, _build.NVCC_FLAGS
    kernel_flags = _build.KERNEL_FLAGS
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        for i, (name, edits, extra) in enumerate(VARIANTS):
            _build.CSRC_DIR = os.path.join(tmp, f"v{i}")
            _build.NVCC_FLAGS = flags + tuple(extra or ())
            _build.KERNEL_FLAGS = kernel_flags if extra is None else {}
            _build._libs.clear()
            _build.build_logs.clear()
            patched_sources(src_dir, _build.CSRC_DIR, edits)
            got_test = megakernel.radiance_lanes(sc.data, spec, *test_lanes,
                                                 10)
            got_more = megakernel.radiance_lanes(sc.data, spec, *more_lanes,
                                                 10)
            out_t, eq_t = share_outside(got_test, want_test)
            out_m, eq_m = share_outside(got_more, want_more)
            out_c, eq_c = share_outside(megakernel.radiance_lanes(
                cornell.data, cornell.spec, *launch, 3), want_launch)
            times = []
            for _ in range(2):
                times.append((
                    chip_smoke.ms_per_launch(
                        lambda: megakernel.radiance_lanes(
                            cornell.data, spec_c, *lanes_c, 0), 3, 20),
                    chip_smoke.ms_per_launch(
                        lambda: megakernel.radiance_lanes(
                            show.data, show.spec, *lanes_s, 0), 3, 10)))
            regs = {}
            for k, log in _build.build_logs.items():
                inst = None
                for line in log.splitlines():
                    m = re.search(r"(megakernel_[a-z]+)I((?:L[bi]\d+E)+)E", line)
                    if "entry function" in line and m:
                        inst = (f"{m.group(1)}<"
                                f"{','.join(re.findall(r'\d+', m.group(2)))}>")
                    r = re.search(r"Used (\d+) registers", line)
                    if r and inst:
                        regs[inst] = int(r.group(1))
            res = {"variant": name,
                   "test_lanes_outside": out_t, "test_bit_equal": eq_t,
                   "more_lanes_outside": out_m, "more_bit_equal": eq_m,
                   "cornell_launch_outside": out_c,
                   "cornell_launch_bit_equal": eq_c,
                   "cornell_ms": [round(t[0], 4) for t in times],
                   "showcase_ms": [round(t[1], 4) for t in times],
                   "registers": regs}
            print(res, flush=True)
            results.append(res)
    _build.CSRC_DIR, _build.NVCC_FLAGS = src_dir, flags
    _build.KERNEL_FLAGS = kernel_flags
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
