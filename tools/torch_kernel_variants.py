"""Times variants of the port's tree kernel and table fold beside what
the port ships, on one NVIDIA GPU, each held against its plain PyTorch
version.

    python3 tools/torch_kernel_variants.py [--only tree|fold]

The port itself has one form of each choice.  A variant is built here from
a copy of ``raytrace_tpu_torch/csrc`` with one line of the source replaced
(``patched_sources``), or by setting the size up to which the wrappers
stage the table in shared memory.  The tree kernel
(``csrc/megakernel_tree.cu``): the blocks an SM that its launch bounds leave
room for, and so its registers, on materials_showcase (2,097,152 random
lanes, and the CLI's own launch) and on the mixed 1,006-object field.  The
table fold (``csrc/render_common.cuh``): every thread for its own ray, the
warp for one ray after the other, and the choice per warp by the probe of
the chunk bounds (``warp_rays_part``, what ships), each with the table in
device memory and staged in shared memory, in the linear kernel's large
instance (1,006 and 4,006 objects, 2,097,152 pixel-ordered lanes), the
tree kernel's (1,006 objects, mixed materials) and the scan kernel (the
launch's camera rays, and random rays).  Before the fold's times it
prints, per depth, the sphere chunks a ray enters and the union over the
32 rays of a warp, which is what the first variant's warp runs, and the
share that the probe sees.  Every number is printed with the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def instance_report(build_logs) -> None:
    """ptxas registers, stack frame and static shared memory per kernel
    instance."""
    for k, log in build_logs.items():
        inst, frame = None, "?"
        for line in log.splitlines():
            m = re.search(r"(megakernel_[a-z]+|scan_hit_kernel|skybox_kernel)"
                          r"(?:I((?:L[bi]\d+E)+)E|E)", line)
            if "entry function" in line and m:
                args = re.findall(r"\d+", m.group(2) or "")
                inst = f"{m.group(1)}<{','.join(args)}>"
            elif inst and "stack frame" in line:
                frame = re.search(r"(\d+) bytes stack frame", line).group(1)
            elif inst and "registers" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"  {inst}: {regs} registers, {frame} B stack frame")
                inst = None


TREE_BLOCKS = "constexpr int TREE_MIN_BLOCKS = 8, TREE_LARGE_MIN_BLOCKS = 4;"
FOLD_CHOICE = "if (warp_rays_part<SH>(tb, mask, q))"


def patched_sources(old: str | None = None, new: str = "") -> None:
    """Points the build at a copy of the kernel sources in which every
    ``old`` reads ``new`` (it must occur), or back at the port's own
    sources, and drops the loaded libraries so that the next launch builds
    and loads that version."""
    from raytrace_tpu_torch.ops import _build, intersect_scan

    own = os.path.join(REPO, "raytrace_tpu_torch", "csrc")
    if old is None:
        _build.CSRC_DIR = own
    else:
        copy = os.path.join(tempfile.mkdtemp(prefix="rt_variant_"), "csrc")
        shutil.copytree(own, copy)
        hits = 0
        for fname in os.listdir(copy):
            with open(os.path.join(copy, fname)) as f:
                text = f.read()
            hits += text.count(old)
            with open(os.path.join(copy, fname), "w") as f:
                f.write(text.replace(old, new))
        if hits == 0:
            raise AssertionError(f"the sources no longer hold {old!r}")
        _build.CSRC_DIR = copy
    _build._libs.clear()
    intersect_scan._lib_ready = None


def probe_share(tb, ro, rd, probes: int = 8):
    """What warp_rays_part of csrc/render_common.cuh computes, for each 32
    consecutive rays: of the probed chunks that any ray may enter, the
    share of the rays that may enter it.  Returns its 10%, 50% and 90%
    quantiles over the warps."""
    from raytrace_tpu_torch.ops.intersect_scan import _may_enter

    a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z
    inv2a = 0.5 / torch.where(a > 0, a, 1.0)
    n_sph_chunks = tb.n_sph_pad // 32
    probes = min(probes, n_sph_chunks)
    inf = torch.full_like(a, float("inf"))
    may = torch.stack([_may_enter(tb.bounds[k * n_sph_chunks // probes], ro,
                                  rd, a, inv2a, inf)
                       for k in range(probes)]).reshape(probes, -1, 32)
    entering = may.sum(dim=2).sum(dim=0).double()
    entered = may.any(dim=2).sum(dim=0).double()
    share = (entering / (32 * entered.clamp(min=1)))[entered > 0]
    return [round(float(x), 3) for x in torch.quantile(
        share, torch.tensor([0.1, 0.5, 0.9], dtype=torch.float64,
                            device=share.device))]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("tree", "fold"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs an NVIDIA GPU")
    device = torch.device("cuda", 0)

    import chip_smoke as cs

    from raytrace_tpu_torch.ops import _build, intersect_scan
    from raytrace_tpu_torch.ops.intersect import scene_tables
    from raytrace_tpu_torch.ops.vec import V3
    from raytrace_tpu_torch.render import megakernel, work
    from raytrace_tpu_torch.render.integrator import primary_rays
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    smi = cs.nvidia_smi()
    print(f"device: {smi}")
    t0 = time.perf_counter()
    threads = [threading.Thread(target=_build.load, args=(k,))
               for k in megakernel.KERNELS]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(f"built in {time.perf_counter() - t0:.1f} s")
    instance_report(_build.build_logs)

    def timed(fn, reps):
        return [round(cs.ms_per_launch(fn, 2, reps), 4) for _ in range(2)]

    def bit_equal(got, want) -> float:
        g, w = torch.stack(list(got)), torch.stack(list(want))
        return float((g == w).all(dim=0).float().mean())

    if args.only != "fold":
        show = load_scene_file(cs.SHOWCASE, device=device)
        mixed = make_sphere_field(1000, mix_materials=True, device=device)
        lanes_r = [t.to(torch.int32) for t in cs.random_lanes(
            show.spec, 1 << 21, cs.SEED, device)]
        lanes_c = [t.to(torch.int32)
                   for t in cs.cli_launch_lanes(show.spec, device)[0]]
        lanes_p = [t.to(torch.int32)
                   for t in cs.pixel_lanes(1024, 1 << 20, 2, 1, device)]
        chk = cs.random_lanes(show.spec, 65536, cs.SEED, device)
        want = megakernel.radiance_lanes_reference(show.data, show.spec, *chk,
                                                   cs.SEED)
        for label, lanes in (("random lanes", lanes_r),
                             ("the CLI's launch", lanes_c)):
            w = work.path_work(show.data, show.spec,
                               [work.warp_sample(t) for t in lanes], 0)
            print(f"materials_showcase, {label}: {w['visits']:.3f} live nodes "
                  f"per lane, {w['warp_visits']:.3f} the largest of a warp")
        print("tree kernel, room for (small, large) blocks an SM; (8, 4) "
              "ships:")
        for small, large in ((8, 4), (8, 3), (6, 3), (5, 3)):
            patched_sources(TREE_BLOCKS, TREE_BLOCKS.replace(
                "= 8", f"= {small}").replace("= 4", f"= {large}"))
            got = megakernel.radiance_lanes(show.data, show.spec, *chk,
                                            cs.SEED)
            if bit_equal(got, want) != 1.0:
                raise AssertionError(f"({small}, {large}): not bit-equal")
            ms_r = timed(lambda: megakernel.radiance_lanes(
                show.data, show.spec, *lanes_r, 0), 10)
            ms_c = timed(lambda: megakernel.radiance_lanes(
                show.data, show.spec, *lanes_c, 0), 10)
            ms_m = timed(lambda: megakernel.radiance_lanes(
                mixed.data, mixed.spec, *lanes_p, 0), 5)
            log = _build.build_logs[megakernel.KERNEL_TREE]
            regs = [re.findall(inst + r".*?Used (\d+) registers", log,
                               re.S)[:1]
                    for inst in ("megakernel_treeILi8ELi0ELb0E",
                                 "megakernel_treeILi8ELi2ELb0E")]
            print(f"  ({small}, {large}), {regs} registers, bit-equal on the "
                  f"showcase: {ms_r} ms per 2097152 random lanes, {ms_c} ms "
                  f"per {lanes_c[0].shape[0]} lanes of the CLI's launch; "
                  f"mixed 1,006-object field {ms_m} ms per 2097152 lanes; on "
                  f"{smi}",
                  flush=True)
        patched_sources()

    if args.only != "tree":
        modes = (("thread per ray", "if (false)"),
                 ("warp per ray", "if (true)"),
                 ("warp per ray where the rays part (ships)", FOLD_CHOICE))
        staged_up_to = intersect_scan.FOLD_SHARED_MAX_BYTES
        # where the table lies: nowhere staged, or wherever a block holds it
        places = (("device", 0), ("shared", 200 * 1024))
        k_lin, k_tree = megakernel.KERNEL_LINEAR, megakernel.KERNEL_TREE
        fields = [(label, make_sphere_field(n_sph, mix_materials=mix,
                                            device=device), kname)
                  for label, n_sph, mix, kname in (
                      ("linear, 1,006 objects", 1000, False, k_lin),
                      ("linear, 4,006 objects", 4000, False, k_lin),
                      ("mixed, 1,006 objects", 1000, True, k_tree))]
        n = 1 << 21
        lanes = [t.to(torch.int32) for t in cs.pixel_lanes(1024, n // 2, 2, 1,
                                                          device)]
        for label, sc, kname in fields:
            tb = scene_tables(sc.data, sc.spec)
            n_sph_chunks = tb.n_sph_pad // 32
            w = work.path_work(sc.data, sc.spec,
                               [work.warp_sample(t) for t in lanes], 0)
            print(f"{label} ({n_sph_chunks} sphere chunks): {w['visits']:.3f} "
                  f"live nodes per lane, {w['warp_visits']:.3f} the largest "
                  f"of a warp; per depth (live share, chunks a ray enters, "
                  f"union over a warp): "
                  + ", ".join(f"{d}: {a:.3f} {b:.2f} {c:.2f}"
                              for d, (a, b, c) in w["by_depth"].items()))
            if kname == megakernel.KERNEL_LINEAR:
                from raytrace_tpu_torch.render.integrator import (
                    tree_loop_entry, tree_loop_node)
                ro, rd, k1, k2 = primary_rays(
                    sc.data, sc.spec, *[work.warp_sample(t) for t in lanes], 0)
                one = torch.ones_like(ro.x)
                e = tree_loop_entry(ro, rd, one, V3(one, one, one), one, k1,
                                    k2, ro.x.dtype)
                for d in range(3):
                    print(f"  the probe's share at depth {d} (10%, 50%, 90% "
                          f"of the warps): "
                          f"{probe_share(tb, V3(*e[0:3]), V3(*e[3:6]))}")
                    e = tree_loop_node(sc.data, sc.spec, 1, e, d)[1][0]
            chk = cs.random_lanes(sc.spec, 65536, cs.SEED, device)
            if kname == megakernel.KERNEL_TREE:
                chk = [t[:16384] for t in chk]
            want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *chk,
                                                       cs.SEED)
            for mname, mode in modes:
                patched_sources(FOLD_CHOICE, mode)
                for place, limit in places:
                    intersect_scan.FOLD_SHARED_MAX_BYTES = limit
                    got = megakernel.radiance_lanes(sc.data, sc.spec, *chk,
                                                    cs.SEED)
                    print(f"  {mname}, table in {place} memory:")
                    stats = cs.compare(got, want)
                    if stats["share_outside"] > 0:
                        raise AssertionError("a lane outside the rule")
                    ms = timed(lambda: megakernel.radiance_lanes(
                        sc.data, sc.spec, *lanes, 0), 5)
                    print(f"    {ms} ms per {n}-lane call; on {smi}",
                          flush=True)
            if kname != megakernel.KERNEL_LINEAR:
                continue
            cam_o, cam_d, _, _ = primary_rays(sc.data, sc.spec, *lanes, 0)
            rs = np.random.RandomState(cs.SEED)
            rand_o = V3(*(torch.from_numpy(rs.uniform(-28, 28, n).astype(
                np.float32)).to(device) for _ in range(3)))
            rand_d = V3(*(torch.from_numpy(rs.normal(0, 1, n).astype(
                np.float32)).to(device) for _ in range(3)))
            for rlabel, o, d in (("camera rays", cam_o, cam_d),
                                 ("random rays", rand_o, rand_d)):
                sub = [V3(*(work.warp_sample(c, 2048) for c in v))
                       for v in (o, d)]
                want = intersect_scan.scan_hit_reference(
                    tb.table, tb.ids, tb.n_sph_pad, *sub, tb.bounds,
                    return_entered=True, return_mask=True)
                union = want[4].reshape(-1, 32, n_sph_chunks).any(dim=1)
                print(f"  scan kernel, {rlabel}: a ray enters "
                      f"{float(want[3].float().mean()):.2f} chunks, a warp's "
                      f"union {float(union.sum(dim=1).float().mean()):.2f}; "
                      f"the probe's share (10%, 50%, 90% of the warps) "
                      f"{probe_share(tb, *sub)}")
                for mname, mode in modes:
                    patched_sources(FOLD_CHOICE, mode)
                    for place, limit in places:
                        intersect_scan.FOLD_SHARED_MAX_BYTES = limit
                        got = intersect_scan.scan_hit(
                            tb.table, tb.ids, tb.n_sph_pad, *sub, tb.bounds)
                        same = all(bool((g == w_).all())
                                   for g, w_ in zip(got, want[:3]))
                        ms = timed(lambda: intersect_scan.scan_hit(
                            tb.table, tb.ids, tb.n_sph_pad, o, d, tb.bounds),
                            10)
                        print(f"    {mname}, table in {place} memory: "
                              f"equal to the plain scan: {same}; {ms} ms per "
                              f"{n}-ray call; on {smi}", flush=True)
                        if not same:
                            raise AssertionError("the scan kernel differs")
        intersect_scan.FOLD_SHARED_MAX_BYTES = staged_up_to
        patched_sources()
    print(f"on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
