"""Times variants of the port's linear kernel, tree kernel and table fold
beside what the port ships, on one NVIDIA GPU, each held against its plain
PyTorch version.

    python3 tools/torch_kernel_variants.py [--only k1|tree|fold]
        [--parent DIR] [--sass-dir DIR]

The linear kernel (K1, ``--only k1``): the steps of its redesign one after
the other, from the sources of the parent tree (``--parent``, a checkout
of the commit before them; its ``raytrace_tpu_torch/csrc`` is used) to the
port's own: the parent; the parent reading a sphere's r * r and a plane's
p.n from the rows (``K1_PRE``); the port's sources as they are; and beside
these the port's other forms (``K1_FORMS``): a persistent grid, the sphere
test without its branch, the winner's row read as six 128-bit words, the
object loops unrolled as nvcc chooses, sinf and cosf in place of sincosf,
sincosf in the lens sample too, and other blocks an SM for the small
instances' launch bounds.  ``--sass-dir`` keeps each one's ``cuobjdump
-sass``.  Each is timed in turns (the steps forward, then everything
backward) at 2,097,152 lanes on cornell (lean), the lit mirror scene
(lit), the open cornell under the sky (sky) and, beside them, the tree
kernel on materials_showcase, which shares the small-scene device code;
each is held against the plain version on cornell's 4,194,304-lane CLI
launch, where the share of lanes outside the per-lane rule and of lanes
equal to the bit are its forks.

The port itself has one form of each choice.  A variant is built here from
a copy of ``raytrace_tpu_torch/csrc`` with lines of the source replaced
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
import dataclasses
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
K1_BLOCKS = "constexpr int LINEAR_MIN_BLOCKS = 1, LINEAR_LIT_MIN_BLOCKS = 7;"
# the parent's object test, reading the constants that pack_scene now puts
# in column 22 of a row (R_PRE) instead of computing them
K1_PRE = [("r[R_P + 2], r[R_Q], ox, oy, oz", "r[R_P + 2], r[22], ox, oy, oz"),
          ("ocz, ocx, ocy, ocz) - rad * rad;", "ocz, ocx, ocy, ocz) - rad;"),
          ("const float p_dot_n = r[R_P] * qx + r[R_P + 1] * qy + r[R_P + 2] * qz;",
           "const float p_dot_n = r[22];")]
# the small instances' grid persistent: as many blocks as the SMs hold
# at once, each thread walking lanes first, first + stride, ...
K1_PERSISTENT = [
    ("  const long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x;\n",
     "  for (long long lane = (long long)blockIdx.x * blockDim.x + threadIdx.x; lane < n;\n"
     "       lane += (long long)gridDim.x * blockDim.x) {\n"),
    ("  out[2 * n + lane] = accz;\n}\n", "  out[2 * n + lane] = accz;\n  }\n}\n"),
    ("  megakernel_linear<LIT, LARGE, SKY><<<(unsigned)blocks,",
     "  long long grid = blocks;\n"
     "  int device = 0, sms = 0, per_sm = 0;\n"
     "  cudaGetDevice(&device);\n"
     "  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n"
     "  cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "      &per_sm, megakernel_linear<LIT, LARGE, SKY>, threads, smem);\n"
     "  if (LARGE == 0 && per_sm > 0 && grid > (long long)sms * per_sm)\n"
     "    grid = (long long)sms * per_sm;\n"
     "  megakernel_linear<LIT, LARGE, SKY><<<(unsigned)grid,")]
# the sphere test without its branch: the root and the square root on
# every lane, as the parent computes them
K1_BRANCHLESS = [(
    """  // the root and its square root only where a thread of the warp may hit
  if (!(disc > 0.0f)) return false;
  const float sq = sqrtf(disc);
  const float t1 = (-b - sq) * inv2a;
  t = t1 > 0.0f ? t1 : (-b + sq) * inv2a;
  return t > 0.0f;""",
    """  const bool has = disc > 0.0f;
  const float sq = sqrtf(has ? disc : 1.0f);
  const float t1 = (-b - sq) * inv2a;
  const float t2 = (-b + sq) * inv2a;
  t = t1 > 0.0f ? t1 : t2;
  return has && t > 0.0f;""")]
K1_VEC_ROW = [(
    """  const float* r;  // the one load of the winner's row
  if constexpr (LARGE != 0)
    r = sc.row_by_id(best);
  else
    r = sc.row(best);
""", """  const float* r;
  float4 row4[ROW / 4];
  if constexpr (LARGE != 0) {
    r = sc.row_by_id(best);
  } else {
    for (int k = 0; k < ROW / 4; ++k)
      row4[k] = reinterpret_cast<const float4*>(sc.row(best))[k];
    r = reinterpret_cast<const float*>(row4);
  }
""")]
K1_UNROLLED = [("#pragma unroll 1\n", "")]
K1_NO_SINCOS = [
    ("sincosf(phi, &sin_p, &cos_p);", "sin_p = sinf(phi), cos_p = cosf(phi);")]
K1_LENS_SINCOS = [
    ("    const float lx = cosf(theta) * r, ly = sinf(theta) * r;",
     "    float sin_t, cos_t;\n    sincosf(theta, &sin_t, &cos_t);\n"
     "    const float lx = cos_t * r, ly = sin_t * r;")]


OWN_CSRC = os.path.join(REPO, "raytrace_tpu_torch", "csrc")


def patched_sources(old: str | None = None, new: str = "", base: str = OWN_CSRC,
                    edits=()) -> None:
    """Points the build at a copy of the kernel sources ``base`` in which
    every ``old`` reads ``new``, and each (old, new) of ``edits`` likewise
    (each must occur), or with no edit at all back at the port's own
    sources, and drops the loaded libraries so that the next launch builds
    and loads that version."""
    from raytrace_tpu_torch.ops import _build, intersect_scan

    edits = list(edits) + ([(old, new)] if old is not None else [])
    if not edits and base == OWN_CSRC:
        _build.CSRC_DIR = OWN_CSRC
    else:
        copy = os.path.join(tempfile.mkdtemp(prefix="rt_variant_"), "csrc")
        shutil.copytree(base, copy)
        texts = {}
        for fname in os.listdir(copy):
            with open(os.path.join(copy, fname)) as f:
                texts[fname] = f.read()
        for o, n in edits:
            if not any(o in t for t in texts.values()):
                raise AssertionError(f"the sources no longer hold {o!r}")
            texts = {k: t.replace(o, n) for k, t in texts.items()}
        for fname, text in texts.items():
            with open(os.path.join(copy, fname), "w") as f:
                f.write(text)
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


def k1_steps(parent: str | None):
    """(name, source directory, edits) of each step of K1's redesign."""
    steps = []
    if parent is not None:
        base = os.path.join(parent, "raytrace_tpu_torch", "csrc")
        steps += [("parent", base, []),
                  ("+ r*r and p.n from the rows", base, K1_PRE)]
    return steps + [("+ the keys' prefix, sincosf, rolled loops (ships)",
                     OWN_CSRC, [])]


def _blocks(lean: int, lit: int):
    return [(K1_BLOCKS, K1_BLOCKS.replace("= 1,", f"= {lean},").replace(
        "= 7;", f"= {lit};"))]


# other forms of the port's K1, each timed once beside what ships
K1_FORMS = (("a persistent grid", K1_PERSISTENT),
            ("the sphere test without its branch", K1_BRANCHLESS),
            ("the winner's row in 128-bit loads", K1_VEC_ROW),
            ("object loops unrolled", K1_UNROLLED),
            ("sinf and cosf, not sincosf", K1_NO_SINCOS),
            ("sincosf in the lens sample too", K1_LENS_SINCOS),
            ("the lit instance without its bound", _blocks(1, 1)),
            ("lean and sky held to 12 blocks an SM", _blocks(12, 7)))


def k1_variants(parent: str | None, smi: str, sass_dir: str | None) -> None:
    """The steps of K1's redesign and its register budgets, in turns."""
    import chip_smoke as cs

    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.render import megakernel, work
    from raytrace_tpu_torch.scene import dsl
    from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file

    device = torch.device("cuda", 0)
    cornell = load_scene_file(cs.SCENE, device=device)
    spec_c = dataclasses.replace(cornell.spec, width=1024, height=1024)
    lit = build_scene(dsl.parse(cs.LIT_MIRROR), device=device)
    show = load_scene_file(cs.SHOWCASE, device=device)
    tmp = tempfile.TemporaryDirectory()
    cs.write_sky_faces(tmp.name, cs.SEED)
    path = os.path.join(tmp.name, "cornell_sky.txt")
    with open(cs.SCENE) as f:
        text = cs.under_the_sky(f.read(), ("(0, 0, -4)", "(0, 7, 0)",
                                           "(-3.5, 0, 0)", "(3.5, 0, 0)"))
    with open(path, "w") as f:
        f.write(text)
    sky = load_scene_file(path, device=device)
    spec_s = dataclasses.replace(sky.spec, width=1024, height=1024)
    pix = [t.to(torch.int32) for t in cs.pixel_lanes(1024, (1 << 21) // 16, 16,
                                                      1, device)]
    cases = (("lean, cornell", cornell.data, spec_c, pix),
             ("lit, mirror scene", lit.data, lit.spec,
              [t.to(torch.int32) for t in cs.random_lanes(
                  lit.spec, 1 << 21, cs.SEED, device)]),
             ("sky, open cornell", sky.data, spec_s, pix),
             ("tree, materials_showcase", show.data, show.spec,
              [t.to(torch.int32) for t in cs.random_lanes(
                  show.spec, 1 << 21, cs.SEED, device)]))
    # the forks: cornell's CLI launch, against one plain run
    launch = cs.pixel_lanes(512, 512 * 512, 16, 1, device)
    want = torch.stack(list(megakernel.radiance_lanes_reference(
        cornell.data, cornell.spec, *launch, cs.SEED)))
    works = {}
    for label, data, spec, lanes in cases[:3]:
        w = works[label] = work.path_work(
            data, spec, [work.warp_sample(t) for t in lanes], 0)
        print(f"{label}: {w['visits']:.3f} live nodes per lane, "
              f"{w['hits']:.3f} hits; recounted bound "
              f"{cs.k1_bound(spec, 1 << 21, w)[0]:.4f} ms; on {smi}")

    steps = k1_steps(parent)
    n_steps = len(steps)
    steps += [(name, OWN_CSRC, edits) for name, edits in K1_FORMS]
    # the steps forward, then everything backward
    order = list(range(n_steps)) + list(range(len(steps) - 1, -1, -1))
    regs = {}
    times = {i: {c[0]: [] for c in cases} for i in range(len(steps))}
    failed = []
    for i in order:
        name, base, edits = steps[i]
        if name in failed:
            continue
        patched_sources(base=base, edits=edits)
        _build.build_logs.clear()  # a library built earlier leaves no report
        t0 = time.perf_counter()
        errors = []

        def build(k):
            try:
                _build.load(k)
            except _build.KernelBuildError as e:
                errors.append(e)

        threads = [threading.Thread(target=build, args=(k,))
                   for k in (megakernel.KERNEL_LINEAR, megakernel.KERNEL_TREE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:  # a form nvcc refuses: say so and go on with the others
            print(f"{name}: not built: {errors[0]}", flush=True)
            failed.append(name)
            continue
        built = time.perf_counter() - t0
        got = torch.stack(list(megakernel.radiance_lanes(
            cornell.data, cornell.spec, *launch, cs.SEED)))
        d = (got.double() - want.double()).abs()
        outside = float(1 - (d <= cs.LANE_RTOL * want.double().abs().clamp(
            min=1)).all(dim=0).float().mean())
        equal = float((got == want).all(dim=0).float().mean())
        for label, data, spec, lanes in cases:
            times[i][label] += [round(cs.ms_per_launch(
                lambda: megakernel.radiance_lanes(data, spec, *lanes, 0),
                3, 10 if label.startswith("tree") else 20), 4)
                for _ in range(2)]
        if i not in regs:  # a fresh build's report
            log = _build.build_logs.get(megakernel.KERNEL_LINEAR, "")
            regs[i] = {k: cs.ptxas_registers(log, v)
                       for k, v in cs.K1_INSTANCES.items()}
        sass = cs.cuobjdump_sass(_build.library_path(megakernel.KERNEL_LINEAR))
        if sass_dir is not None:
            os.makedirs(sass_dir, exist_ok=True)
            with open(os.path.join(sass_dir, f"k1_{i}.sass"), "w") as f:
                f.write(sass)
        for (label, _, spec, _), inst in zip(cases, cs.K1_INSTANCES):
            per_lane, rep = cs.k1_issue(sass, cs.K1_INSTANCES[inst], spec,
                                        works[label])
            print(f"  {label}: {per_lane:.0f} instructions a lane (upper "
                  f"estimate), executed per node {rep['node_executed']}")
        print(f"{name}: built in {built:.1f} s; {regs[i]} registers; cornell's "
              f"CLI launch, {got.shape[1]} lanes: {outside:.5f} outside the "
              f"rule, {equal:.5f} equal to the bit; ms per 2097152 lanes "
              f"so far {times[i]}; on {smi}", flush=True)
        if outside > 1 - cs.MIN_LANES_OK:
            raise AssertionError(f"{name}: outside the rule")
    patched_sources()
    tmp.cleanup()
    print(f"K1's steps, the best of each step's runs, ms per 2097152 lanes; "
          f"on {smi}:")
    for i, (name, _, _) in enumerate(steps):
        if name in failed:
            continue
        print(f"  {name} ({regs[i]} registers): " + ", ".join(
            f"{label} {min(v):.4f}" for label, v in times[i].items()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k1", "tree", "fold"))
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent tree, for K1's steps")
    ap.add_argument("--sass-dir", default=None,
                    help="where to keep the SASS of each of K1's forms")
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

    if args.only in (None, "k1"):
        k1_variants(args.parent, smi, args.sass_dir)
    if args.only == "k1":
        print(f"on {smi}")
        return 0

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
