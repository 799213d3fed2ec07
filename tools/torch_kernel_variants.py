"""Times variants of the port's linear kernel, tree kernel and table fold
beside what the port ships, on one NVIDIA GPU, each held against its plain
PyTorch version.

    python3 tools/torch_kernel_variants.py
        [--only k1|k4|tree|fold|fused|ring] [--parent DIR] [--sass-dir DIR]

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

The skybox lookup (K4, ``--only k4``): the texel layouts in turns (the
forms forward, then backward): the parent's cube with 12 scalar loads
(from ``--parent``), float4 texels, each texel packed with its three
bilinear neighbours in 48 bytes and padded to 64 (what ships), row pairs
of 32 bytes, and texture objects read by ``tex2D`` and by
``tex2Dgather``; and the render kernels' sky instances with the lookup
taken out.  Each is timed on ``csrc/skybox.cu`` (2,097,152 random
directions and the 4,194,304 primary-ray directions of the cornell sky
launch), K1+sky (the open cornell) and K3+sky (the showcase under the
sky), each held against its plain version, with the registers and
``skybox_kernel``'s loads and integer instructions from its SASS; the
texture objects are also made and freed 100 times against the card's
used bytes.

The fused kernels against the parent (``--only fused --parent DIR``): K1
on cornell_indirect, K3 on materials_showcase, K1-large and K3-large on
the 1,006-object linear and mixed fields, each on 2,097,152 random lanes,
and ``csrc/skybox.cu`` on 2,097,152 random directions of a random 6 x 1024
x 1024 cube, built from the parent's sources and from the port's in turns
(parent, port, port, parent): each one's best time of three runs of five
calls, and a hash of its output, which must be the same in all four (a
change to the shared device code that leaves these kernels' bits alone).
Both sides launch through the port's wrapper, on four lane tensors: a
parent whose entries take no factored lanes (no ``samples`` and ``lens``
after ``cam``) is given those words as unnamed arguments, which it
leaves unread (``PARENT_LANE_WORDS``).

The ring's two copy kernels (``--only ring [--parent DIR]``):
``ring_start`` and ``ring_rows`` of ``csrc/ring_shade.cu`` in each form,
built beside one another and timed in turns (the forms forward, then
backward) as bare launches of their entries at 2,097,152 pixel-ordered
lanes of the 1,006-object linear field's first round: the parent's file
(from ``--parent``; its ``ring_start`` takes int32 ids, and is timed also
with its wrapper's conversion of the image loop's int64 ids), the rows
staged through shared memory by the block, the file at 64 and at 256
threads a block, and what ships (a warp copies its 32 rows as one piece;
the ids read as they come).  ``ring_start`` on int32 and int64 ids,
``ring_rows`` at k = 1 (the whole row table) and at k = 2 (shard 0, half
the rows, against every lane's winner).  Each form is held to the plain
twin to the bit (``start_reference``, ``parallel/ring.py::_select_rows``),
and each one's registers and its global loads and stores by width (``LDG``
/ ``STG`` in its SASS) are printed.  Beside them, from the parent's
library and the port's, ``ring_shadow`` and ``ring_finish``, which read
the rows: whether each instance's SASS is the same, and each one's device
time in turns, held to its twin to the bit.

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
import hashlib
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
# the fold's choice per warp, which the fold's forms replace
FOLD_CHOICE = "if (warp_rays_part<SH>(tb, mask, q))"
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
    from raytrace_tpu_torch.models import backgrounds
    from raytrace_tpu_torch.ops import _build, intersect_scan
    from raytrace_tpu_torch.render import ring_shade

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
    backgrounds._lib_ready = None
    ring_shade._lib_ready = None


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


# ---- K4, the skybox lookup.  What ships (render_common.cuh, Sky;
# models/backgrounds.py::pack_sky): the faces packed per texel with its
# three bilinear neighbours and a pad, three 16-byte loads from one
# 64-byte block a lookup.  Each other form
# replaces parts of the skybox block of render_common.cuh, from SKY_BLOCK[0]
# to SKY_BLOCK[1], and the function that hands the kernels their faces
# (backgrounds.sky_buffer).
SKY_BLOCK = ("// ---- skybox (models/backgrounds.py::_skybox).",
             "// the scene as the kernels see it")
SKY_STRUCT = """struct Sky {
  const float4* quads;  // (6, hmax, wmax, 16) float32; null: a solid background
  int hmax, wmax;       // strides of the padded faces
  int h[6], w[6];       // each face's own size: px nx py ny pz nz
};"""
SKY_FETCH = """  // q0 = c00.rgb c01.r, q1 = c01.gb c10.rg, q2 = c10.b c11.rgb
  const float4* q =
      sky.quads + 4u * (unsigned)((face * sky.hmax + (int)y0) * sky.wmax + (int)x0);
  const float4 q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
"""
SKY_BLEND = """  r = mix(mix(q0.x, omy, q0.w, yy), omx, mix(q1.z, omy, q2.y, yy), xx);
  g = mix(mix(q0.y, omy, q1.x, yy), omx, mix(q1.w, omy, q2.z, yy), xx);
  b = mix(mix(q0.z, omy, q1.y, yy), omx, mix(q2.x, omy, q2.w, yy), xx);"""
SKY_MAKE = "  sky.quads = (const float4*)quads;"
# the four texels as c00, c01, c10, c11 (float4, RGB in x, y, z)
_BLEND4 = """  r = mix(mix(c00.x, omy, c01.x, yy), omx, mix(c10.x, omy, c11.x, yy), xx);
  g = mix(mix(c00.y, omy, c01.y, yy), omx, mix(c10.y, omy, c11.y, yy), xx);
  b = mix(mix(c00.z, omy, c01.z, yy), omx, mix(c10.z, omy, c11.z, yy), xx);"""
# (a) float4 texels: RGB and a pad float, one 16-byte load a texel
K4_FLOAT4 = [
    (SKY_STRUCT, SKY_STRUCT.replace(
        "const float4* quads;  // (6, hmax, wmax, 16)",
        "const float4* quads;  // (6, hmax, wmax, 4) ")),
    (SKY_FETCH, """  const int x0i = (int)x0, y0i = (int)y0;
  const int x1i = min(x0i + 1, fw - 1), y1i = min(y0i + 1, fh - 1);
  const float4* row0 = sky.quads + (unsigned)((face * sky.hmax + y0i) * sky.wmax);
  const float4* row1 = sky.quads + (unsigned)((face * sky.hmax + y1i) * sky.wmax);
  const float4 c00 = __ldg(row0 + x0i), c10 = __ldg(row0 + x1i);
  const float4 c01 = __ldg(row1 + x0i), c11 = __ldg(row1 + x1i);
"""),
    (SKY_BLEND, _BLEND4)]
# (b48) as what ships without the pad: a 48-byte run a lookup, which
# straddles two 64-byte blocks half the time
K4_QUAD48 = [("      sky.quads + 4u * (unsigned)(", "      sky.quads + 3u * (unsigned)(")]
# (f) row pairs: at (face, y, x) texels (y, x) and (y, x1), padded to 8
# floats: a lookup reads two aligned 32-byte entries, rows y0 and y1
K4_ROW_PAIRS = [
    (SKY_FETCH, """  const int y1i = min((int)y0 + 1, fh - 1);
  const float4* e0 = sky.quads + 2u * (unsigned)((face * sky.hmax + (int)y0) * sky.wmax + (int)x0);
  const float4* e1 = sky.quads + 2u * (unsigned)((face * sky.hmax + y1i) * sky.wmax + (int)x0);
  const float4 a0 = __ldg(e0), a1 = __ldg(e1);
  const float2 b0 = __ldg((const float2*)(e0 + 1)), b1 = __ldg((const float2*)(e1 + 1));
"""),
    (SKY_BLEND, """  r = mix(mix(a0.x, omy, a1.x, yy), omx, mix(a0.w, omy, a1.w, yy), xx);
  g = mix(mix(a0.y, omy, a1.y, yy), omx, mix(b0.x, omy, b1.x, yy), xx);
  b = mix(mix(a0.z, omy, a1.z, yy), omx, mix(b0.y, omy, b1.y, yy), xx);""")]
# (c) texture objects: one CUDA array of float4 per face at its own size,
# point filtering, clamp addressing, unnormalized coordinates; the arrays
# and objects made and freed by two C functions of each library
_TEX_HOST = r"""

extern "C" int rt_sky_textures_free(const unsigned long long* tex, void* const* arrays) {
  for (int f = 0; f < 6; ++f) {
    if (tex[f] != 0) cudaDestroyTextureObject((cudaTextureObject_t)tex[f]);
    if (arrays[f] != nullptr) cudaFreeArray((cudaArray_t)arrays[f]);
  }
  return (int)cudaGetLastError();
}

// `texels`: (6, hmax, wmax, 4) float32 in device memory; `tex` and `arrays`
// receive the six faces' objects and arrays, freed again on a failure
extern "C" int rt_sky_textures(const float* texels, const int* face_hw, unsigned long long* tex,
                               void** arrays, void* stream) {
  const int hmax = face_hw[0], wmax = face_hw[1];
  const cudaChannelFormatDesc desc = cudaCreateChannelDesc<float4>();
  for (int f = 0; f < 6; ++f) {
    tex[f] = 0;
    arrays[f] = nullptr;
  }
  cudaError_t err = cudaSuccess;
  for (int f = 0; f < 6 && err == cudaSuccess; ++f) {
    const int h = face_hw[2 + 2 * f], w = face_hw[3 + 2 * f];
    cudaArray_t arr = nullptr;
    err = cudaMallocArray(&arr, &desc, w, h, cudaArrayTextureGather);
    if (err != cudaSuccess) break;
    arrays[f] = arr;
    err = cudaMemcpy2DToArrayAsync(arr, 0, 0, texels + (size_t)f * hmax * wmax * 4,
                                   sizeof(float4) * wmax, sizeof(float4) * w, h,
                                   cudaMemcpyDeviceToDevice, (cudaStream_t)stream);
    if (err != cudaSuccess) break;
    cudaResourceDesc res{};
    res.resType = cudaResourceTypeArray;
    res.res.array.array = arr;
    cudaTextureDesc td{};
    td.addressMode[0] = td.addressMode[1] = cudaAddressModeClamp;
    td.filterMode = cudaFilterModePoint;
    td.readMode = cudaReadModeElementType;
    td.normalizedCoords = 0;
    cudaTextureObject_t t = 0;
    err = cudaCreateTextureObject(&t, &res, &td, nullptr);
    tex[f] = t;
  }
  if (err != cudaSuccess) rt_sky_textures_free(tex, arrays);
  return (int)err;
}"""
_TEX_PICK = """  const cudaTextureObject_t tex =
      face == 0 ? sky.tex[0] : face == 1 ? sky.tex[1] : face == 2 ? sky.tex[2]
      : face == 3 ? sky.tex[3] : face == 4 ? sky.tex[4] : sky.tex[5];
"""
_TEX_COMMON = [
    (SKY_STRUCT, """struct Sky {
  cudaTextureObject_t tex[6];  // one per face: float4 texels at its own size
  int hmax, wmax;
  int h[6], w[6];
};""" + _TEX_HOST),
    (SKY_MAKE, "  for (int f = 0; f < 6 && quads != nullptr; ++f)\n"
               "    sky.tex[f] = ((const unsigned long long*)quads)[f];")]
K4_TEX2D = _TEX_COMMON[:1] + [
    (SKY_FETCH, _TEX_PICK + """  const float4 c00 = tex2D<float4>(tex, x0 + 0.5f, y0 + 0.5f);
  const float4 c01 = tex2D<float4>(tex, x0 + 0.5f, y0 + 1.5f);
  const float4 c10 = tex2D<float4>(tex, x0 + 1.5f, y0 + 0.5f);
  const float4 c11 = tex2D<float4>(tex, x0 + 1.5f, y0 + 1.5f);
"""), (SKY_BLEND, _BLEND4), _TEX_COMMON[1]]
# the gather's footprint at (x0 + 1, y0 + 1) is texels x0..x0+1, y0..y0+1,
# returned as x (x0, y1), y (x1, y1), z (x1, y0), w (x0, y0)
K4_GATHER = _TEX_COMMON[:1] + [
    (SKY_FETCH, _TEX_PICK + """  const float gx = x0 + 1.0f, gy = y0 + 1.0f;
  const float4 R = tex2Dgather<float4>(tex, gx, gy, 0);
  const float4 G = tex2Dgather<float4>(tex, gx, gy, 1);
  const float4 B = tex2Dgather<float4>(tex, gx, gy, 2);
"""), (SKY_BLEND, """  r = mix(mix(R.w, omy, R.x, yy), omx, mix(R.z, omy, R.y, yy), xx);
  g = mix(mix(G.w, omy, G.x, yy), omx, mix(G.z, omy, G.y, yy), xx);
  b = mix(mix(B.w, omy, B.x, yy), omx, mix(B.z, omy, B.y, yy), xx);"""),
    _TEX_COMMON[1]]
# a miss takes the scene's solid color instead of the lookup: what the
# render kernels' sky instances cost without it
K4_NO_LOOKUP = [("      sky_lookup(sc.sky, e.dx, e.dy, e.dz, bx, by, bz);",
                 "      bx = sc.s[H_BG];\n      by = sc.s[H_BG + 1];\n"
                 "      bz = sc.s[H_BG + 2];")]


def sky_block(csrc: str) -> str:
    """The skybox block of ``csrc``/render_common.cuh."""
    with open(os.path.join(csrc, "render_common.cuh")) as f:
        text = f.read()
    return text[text.index(SKY_BLOCK[0]):text.index(SKY_BLOCK[1])]


def cube_sky(cube, spec):
    """The parent's sky: the cube itself."""
    from raytrace_tpu_torch.models import backgrounds

    cube = cube.detach().contiguous()
    return cube, backgrounds.face_sizes_arg(cube, spec)


def float4_sky(cube, spec):
    """(a)'s sky: (6, H, W, 4) float4 texels, the fourth float zero."""
    from raytrace_tpu_torch.models import backgrounds

    face_hw = backgrounds.face_sizes_arg(cube.detach().contiguous(), spec)
    if not _k4_cached("float4", cube):
        c = cube.detach()
        _k4_cache["float4"] = (cube, cube._version, torch.cat(
            [c, c.new_zeros(c.shape[:3] + (1,))], -1).contiguous())
    return _k4_cache["float4"][2], face_hw


def quad48_sky(cube, spec):
    """(b48)'s sky: pack_sky's twelve floats a texel, without the pad."""
    from raytrace_tpu_torch.models import backgrounds

    face_hw = backgrounds.face_sizes_arg(cube.detach().contiguous(), spec)
    if not _k4_cached("quad48", cube):
        q = backgrounds.pack_sky(cube, spec.face_sizes)
        _k4_cache["quad48"] = (cube, cube._version,
                               q[..., :12].contiguous())
    return _k4_cache["quad48"][2], face_hw


def row_pair_sky(cube, spec):
    """(f)'s sky: at (face, y, x) texels (y, x) and (y, min(x + 1, w - 1))
    and two zeros."""
    from raytrace_tpu_torch.models import backgrounds

    face_hw = backgrounds.face_sizes_arg(cube.detach().contiguous(), spec)
    if not _k4_cached("rows", cube):
        q = backgrounds.pack_sky(cube, spec.face_sizes)
        _k4_cache["rows"] = (cube, cube._version, torch.cat(
            [q[..., 0:3], q[..., 6:9], q.new_zeros(q.shape[:3] + (2,))],
            -1).contiguous())
    return _k4_cache["rows"][2], face_hw


def texture_sky(cube, spec):
    """(c)'s sky: six texture objects on float4 CUDA arrays, made by the
    skybox library and freed by a finalizer when the cache lets go of
    them; the kernels take a host pointer to the six handles."""
    import ctypes
    import weakref

    from raytrace_tpu_torch.models import backgrounds
    from raytrace_tpu_torch.ops import _build

    face_hw = backgrounds.face_sizes_arg(cube.detach().contiguous(), spec)
    if not _k4_cached("texture", cube):
        _k4_cache.pop("texture", None)
        c = cube.detach()
        texels = torch.cat([c, c.new_zeros(c.shape[:3] + (1,))], -1).contiguous()
        lib = _build.load(_build.KERNEL_SKY)
        lib.rt_sky_textures.argtypes = [ctypes.c_void_p] * 5
        lib.rt_sky_textures_free.argtypes = [ctypes.c_void_p] * 2
        tex, arrays = (ctypes.c_ulonglong * 6)(), (ctypes.c_void_p * 6)()
        rc = lib.rt_sky_textures(texels.data_ptr(), face_hw, tex, arrays,
                                 torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"texture objects not made: "
                               f"{lib.rt_error_string(rc).decode()}")
        handles = torch.tensor(list(tex), dtype=torch.int64)
        weakref.finalize(handles, lib.rt_sky_textures_free, tex, arrays)
        _k4_cache["texture"] = (cube, cube._version, handles)
    return _k4_cache["texture"][2], face_hw


# each form's last sky: (cube, its version, what the kernels take)
_k4_cache: dict = {}


def _k4_cached(form: str, cube) -> bool:
    entry = _k4_cache.get(form)
    return entry is not None and entry[0] is cube and entry[1] == cube._version


def k4_variants(parent: str | None, smi: str, sass_dir: str | None) -> None:
    """K4's forms in turns (forward, then backward), each on skybox.cu
    (random and coherent directions), K1+sky and K3+sky, each held
    against the plain version; the "no lookup" form on the render kernels
    alone."""
    import chip_smoke as cs

    from raytrace_tpu_torch.models import backgrounds
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.render.integrator import tree_loop_stack
    from raytrace_tpu_torch.scene.builder import load_scene_file

    device = torch.device("cuda", 0)
    tmp = tempfile.TemporaryDirectory()
    cs.write_sky_faces(tmp.name, cs.SEED)
    scenes = {}
    for name in ("cornell", "showcase"):
        path = os.path.join(tmp.name, f"{name}_sky.txt")
        with open(path, "w") as f:
            f.write(cs.sky_scene_text(name))
        scenes[name] = load_scene_file(path, device=device)
    sky, show = scenes["cornell"], scenes["showcase"]
    n = 1 << 21
    dirs = cs.sky_random_directions(n, cs.SEED, device)
    coherent = cs.sky_coherent_directions(sky, device)
    lanes_c = [t.to(torch.int32)
               for t in cs.pixel_lanes(1024, n // 16, 16, 1, device)]
    lanes_s = [t.to(torch.int32)
               for t in cs.random_lanes(show.spec, n, cs.SEED, device)]
    cases = {
        "skybox.cu, random": (lambda: backgrounds.background_color(
            sky.data, sky.spec, dirs), 20),
        "skybox.cu, coherent": (lambda: backgrounds.background_color(
            sky.data, sky.spec, coherent), 20),
        "K1+sky": (lambda: megakernel.radiance_lanes(
            sky.data, sky.spec, *lanes_c, 0), 20),
        "K3+sky": (lambda: megakernel.radiance_lanes(
            show.data, show.spec, *lanes_s, 0), 10)}
    want = {
        "skybox.cu, random": backgrounds._skybox(sky.data.bg_cube, sky.spec,
                                                 dirs),
        "skybox.cu, coherent": backgrounds._skybox(sky.data.bg_cube,
                                                   sky.spec, coherent),
        "K1+sky": megakernel.radiance_lanes_reference(sky.data, sky.spec,
                                                      *lanes_c, 0),
        "K3+sky": megakernel.radiance_lanes_reference(show.data, show.spec,
                                                      *lanes_s, 0)}
    print(f"K4: {n} random directions, {coherent.shape[0]} primary-ray "
          f"directions of the cornell sky launch; K1+sky on the open cornell "
          f"({n} pixel-ordered lanes), K3+sky on the showcase ({n} random "
          f"lanes); on {smi}", flush=True)
    cap = tree_loop_stack(show.spec)[3]
    instances = {"skybox": "skybox_kernel",
                 "K1+sky": cs.K1_INSTANCES["sky"],
                 "K3+sky": f"megakernel_treeILi{megakernel.tree_instance(cap)}"
                           f"ELi0ELb1E"}
    shipped = sky_block(OWN_CSRC)
    forms = []
    if parent is not None:
        forms.append(("parent: the cube, 12 scalar loads", [(
            shipped, sky_block(os.path.join(parent, "raytrace_tpu_torch",
                                            "csrc")))], cube_sky))
    forms += [("(a) float4 texels, 4 loads", K4_FLOAT4, float4_sky),
              ("(b48) texel and neighbours packed in 48 bytes, 3 loads",
               K4_QUAD48, quad48_sky),
              ("(b64) the same padded to 64 bytes (ships)", [],
               backgrounds.sky_buffer),
              ("(f) row pairs, 32 bytes, 4 loads", K4_ROW_PAIRS,
               row_pair_sky),
              ("(c) texture objects, tex2D at 4 texel centres", K4_TEX2D,
               texture_sky),
              ("(c) texture objects, tex2Dgather per channel", K4_GATHER,
               texture_sky),
              ("no lookup: a miss takes the solid color", K4_NO_LOOKUP,
               backgrounds.sky_buffer)]
    order = list(range(len(forms))) + list(range(len(forms) - 1, -1, -1))
    times = {i: {c: [] for c in cases} for i in range(len(forms))}
    regs, sass, failed = {}, {}, []
    ships = backgrounds.sky_buffer
    # the shipped sources were built before, with their report
    shipped_logs = dict(_build.build_logs)
    for i in order:
        name, edits, sky_fn = forms[i]
        if name in failed:
            continue
        patched_sources(edits=edits)
        backgrounds.sky_buffer = sky_fn
        backgrounds._sky_last = None
        _k4_cache.clear()
        _build.build_logs.clear()
        errors = []

        def build(k):
            try:
                _build.load(k)
            except _build.KernelBuildError as e:
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=build, args=(k,)) for k in (
            _build.KERNEL_SKY, _build.KERNEL_LINEAR, _build.KERNEL_TREE)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            print(f"{name}: not built: {errors[0]}", flush=True)
            failed.append(name)
            continue
        built = time.perf_counter() - t0
        no_lookup = edits is K4_NO_LOOKUP
        checks = {}
        try:
            for label, (fn, _) in cases.items():
                if no_lookup and label.startswith("skybox"):
                    continue
                got = fn()
                torch.cuda.synchronize()
                if no_lookup:
                    continue
                if label.startswith("skybox"):
                    d = (got - want[label]).abs()
                    checks[label] = (
                        round(float((got == want[label]).all(dim=1).float()
                                    .mean()), 6),
                        round(float((d <= 1e-6).all(dim=1).float().mean()),
                              6))
                    if checks[label][1] < 0.999:
                        raise AssertionError(f"{label}: outside the rule "
                                             f"{checks[label]}")
                else:
                    checks[label] = cs.compare(got, want[label],
                                               exact=label == "K3+sky")[
                        "bit_equal"]
        except (AssertionError, RuntimeError) as e:
            print(f"{name}: fails its check: {e}", flush=True)
            failed.append(name)
            continue
        for label, (fn, reps) in cases.items():
            if no_lookup and label.startswith("skybox"):
                continue
            times[i][label] += [round(cs.ms_per_launch(fn, 3, reps), 4)
                                for _ in range(2)]
        if i not in regs:
            logs = ({**shipped_logs, **_build.build_logs} if not edits
                    else _build.build_logs)
            regs[i] = {
                k: cs.ptxas_registers(logs.get(
                    _build.KERNEL_SKY if k == "skybox" else
                    _build.KERNEL_LINEAR if k == "K1+sky" else
                    _build.KERNEL_TREE, ""), v)
                for k, v in instances.items()}
            text = cs.cuobjdump_sass(_build.library_path(_build.KERNEL_SKY))
            sass[i] = None if no_lookup else cs.k4_sass(text)
            if sass_dir is not None:
                os.makedirs(sass_dir, exist_ok=True)
                with open(os.path.join(sass_dir, f"k4_{i}.sass"), "w") as f:
                    f.write(text)
            if sky_fn is texture_sky:
                # made and freed 100 times: no growth of the used bytes
                _k4_cache.clear()
                torch.cuda.synchronize()
                free0, _ = torch.cuda.mem_get_info()
                for _ in range(100):
                    texture_sky(sky.data.bg_cube, sky.spec)
                    _k4_cache.clear()
                torch.cuda.synchronize()
                free1, _ = torch.cuda.mem_get_info()
                checks["texture objects made and freed 100 times, used "
                       "bytes grew by"] = free0 - free1
        print(f"{name}: built in {built:.1f} s; registers {regs[i]}; "
              f"skybox SASS {sass[i]}; checks (bit-equal share, share within "
              f"1e-6 / K1's and K3's bit-equal share) {checks}; ms so far "
              f"{times[i]}; on {smi}", flush=True)
    backgrounds.sky_buffer = ships
    backgrounds._sky_last = None
    _k4_cache.clear()
    patched_sources()
    tmp.cleanup()
    print(f"K4's forms, the best of each one's runs, ms per call; on {smi}:")
    for i, (name, _, _) in enumerate(forms):
        if name in failed:
            continue
        print(f"  {name} (registers {regs[i]}): " + ", ".join(
            f"{label} {min(v):.4f}" for label, v in times[i].items() if v))


# a parent's render entries from before the factored lanes take the four
# words that the wrapper passes after ``cam`` (zeros on four lane tensors)
PARENT_LANE_WORDS = ("const uint32_t* cam, const float* scene",
                     "const uint32_t* cam, uint32_t, uint32_t, "
                     "const float* scene")


def fused_against_parent(parent: str, smi: str) -> None:
    """The fused render kernels and the skybox kernel from the parent's
    sources and from the port's, in turns: times and output hashes."""
    import chip_smoke as cs

    from raytrace_tpu_torch.models import backgrounds
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.procedural import make_sphere_field
    from raytrace_tpu_torch.scene.schema import BG_SKYBOX

    device = torch.device("cuda", 0)
    n = 1 << 21
    cornell = load_scene_file(cs.SCENE, device=device)
    calls = {}
    for label, sc in (
            ("K1, cornell", cornell),
            ("K3, showcase", load_scene_file(cs.SHOWCASE, device=device)),
            ("K1-large, 1,006 objects",
             make_sphere_field(1000, mix_materials=False, device=device)),
            ("K3-large, 1,006 mixed",
             make_sphere_field(1000, mix_materials=True, device=device))):
        lanes = [t.to(torch.int32)
                 for t in cs.random_lanes(sc.spec, n, cs.SEED, device)]
        calls[label] = (lambda sc=sc, lanes=lanes: torch.stack(list(
            megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 0))))
    cube = torch.rand((6, 1024, 1024, 3), generator=torch.Generator(
        device=device).manual_seed(cs.SEED), device=device)
    spec = dataclasses.replace(cornell.spec, bg_type=BG_SKYBOX,
                               face_sizes=((1024, 1024),) * 6)
    data = dataclasses.replace(cornell.data, bg_cube=cube)
    dirs = cs.sky_random_directions(n, cs.SEED, device)
    calls["skybox.cu"] = lambda: backgrounds.background_color(data, spec,
                                                              dirs)
    runs = {label: [] for label in calls}
    parent_csrc = os.path.join(parent, "raytrace_tpu_torch", "csrc")
    with open(os.path.join(parent_csrc, "megakernel_linear.cu")) as f:
        parent_edits = ([] if "uint32_t samples" in f.read()
                        else [PARENT_LANE_WORDS])
    for form, base, edits in (("parent", parent_csrc, parent_edits),
                              ("port", OWN_CSRC, []), ("port", OWN_CSRC, []),
                              ("parent", parent_csrc, parent_edits)):
        patched_sources(base=base, edits=edits)
        for label, fn in calls.items():
            digest = hashlib.sha256(
                fn().cpu().numpy().tobytes()).hexdigest()[:16]
            ms = min(cs.ms_per_launch(fn, 2, 5) for _ in range(3))
            runs[label].append((form, ms, digest))
            print(f"  {form}: {label} {ms:.4f} ms, output {digest}; on "
                  f"{smi}", flush=True)
    patched_sources()
    for label, rs in runs.items():
        best = {f: min(ms for g, ms, _ in rs if g == f)
                for f in ("parent", "port")}
        same = len({d for _, _, d in rs}) == 1
        print(f"{label}: best {best['parent']:.4f} ms (parent), "
              f"{best['port']:.4f} ms (port), "
              f"{best['port'] / best['parent']:.4f}x; "
              f"the same output in all four runs: {same}")
        if not same:
            raise AssertionError(f"{label}: the output differs from the "
                                 f"parent's")


# the shipped ring_rows' body (csrc/ring_shade.cu) and the block-wide
# form that stages its rows through shared memory: each thread loads its
# own lane's row, then the block stores its 128 rows as one piece
RING_ROWS_WARP = """  const long long warp0 = lane - (threadIdx.x & 31);
  int local = -1;
  if (lane < n) {
    const long long l = (long long)obj[lane] - first;
    if (l >= 0 && l < per) local = (int)l;
  }
  if (!__any_sync(0xffffffffu, local >= 0)) return;
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int f = (int)(threadIdx.x & 31) + 32 * j;
    const int l = f / PIECES, c = f - l * PIECES;
    const int src = __shfl_sync(0xffffffffu, local, l);
    if (src >= 0) out[(warp0 + l) * PIECES + c] = __ldg(shard + (long long)src * PIECES + c);
  }
"""
RING_ROWS_BLOCK = """  __shared__ float4 stage[RING_THREADS * PIECES];
  __shared__ int keep[RING_THREADS];
  const long long block0 = (long long)blockIdx.x * blockDim.x;
  int local = -1;
  if (lane < n) {
    const long long l = (long long)obj[lane] - first;
    if (l >= 0 && l < per) local = (int)l;
  }
  keep[threadIdx.x] = local;
  if (local >= 0) {
#pragma unroll
    for (int j = 0; j < PIECES; ++j)
      stage[threadIdx.x * PIECES + j] = __ldg(shard + (long long)local * PIECES + j);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < PIECES; ++j) {
    const int f = (int)threadIdx.x + RING_THREADS * j;
    const int l = f / PIECES;
    if (keep[l] >= 0) out[(block0 + l) * PIECES + (f - l * PIECES)] = stage[f];
  }
"""
RING_THREADS_LINE = "constexpr int RING_THREADS = 128;"


def ring_forms(parent: str | None):
    """(name, source directory, edits) of each form of csrc/ring_shade.cu
    that ``--only ring`` times."""
    forms = []
    if parent is not None:
        forms.append(("parent", os.path.join(parent, "raytrace_tpu_torch",
                                             "csrc"), []))
    forms += [("rows staged through shared memory", OWN_CSRC,
               [(RING_ROWS_WARP, RING_ROWS_BLOCK)]),
              ("64 threads a block", OWN_CSRC,
               [(RING_THREADS_LINE, RING_THREADS_LINE.replace("128", "64"))]),
              ("256 threads a block", OWN_CSRC,
               [(RING_THREADS_LINE, RING_THREADS_LINE.replace("128",
                                                              "256"))]),
              ("ships", OWN_CSRC, [])]
    return forms


def global_memory_ops(sass: str, name: str) -> dict:
    """The global loads and stores of the kernel whose mangled name holds
    ``name``, by opcode (the width in its suffix: none for 32 bits, .64,
    .128)."""
    import chip_smoke as cs

    ops = {}
    for _, op, _ in cs.sass_function(sass, name):
        if op.split(".")[0] in ("LDG", "STG"):
            ops[op] = ops.get(op, 0) + 1
    return ops


def resource_registers(path: str) -> dict:
    """Registers of each kernel of a built library by its mangled name,
    from ``cuobjdump -res-usage`` (which reads them from the library, built
    by this process or an earlier one)."""
    import subprocess

    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    r = subprocess.run([tool if os.path.exists(tool) else "cuobjdump",
                        "-res-usage", path], capture_output=True, text=True,
                       timeout=300)
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"Function (\S+?):?\s+REG:(\d+)", r.stdout)}


def ring_neighbours(libs, smi: str) -> None:
    """``ring_shadow`` and ``ring_finish``, which read the rows that
    ``ring_rows`` writes, from the parent's library and from the port's:
    whether each instance's SASS is the same, and each one's device time
    in turns (parent, port, port, parent) at 2,097,152 lanes through the
    port's wrappers (the host's work hidden behind the device's spin; the
    state restored before each ``ring_finish``), held to the plain twin to
    the bit: ``ring_finish`` on the 1,006-object linear and mixed fields'
    first round (K1's and K3's instances), ``ring_shadow`` on random lanes
    of the lit mirror scene."""
    import ctypes

    import chip_smoke as cs

    from raytrace_tpu_torch.ops import intersect
    from raytrace_tpu_torch.parallel import ring
    from raytrace_tpu_torch.parallel.mesh import Mesh
    from raytrace_tpu_torch.render import ring_shade
    from raytrace_tpu_torch.scene import dsl
    from raytrace_tpu_torch.scene.builder import build_scene
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    forms = {name: (lib, sass) for name, lib, _, _, sass in libs
             if name in ("parent", "ships")}
    p, i = ctypes.c_void_p, ctypes.c_int
    for lib, _ in forms.values():
        lib.rt_ring_shadow.argtypes = ([p] + [i] * 5 + [p] * 6
                                       + [ctypes.c_longlong, p])
        lib.rt_ring_finish.argtypes = ([p] * 3 + [i] * 6 + [p] * 9
                                       + [ctypes.c_longlong, p])
        lib.rt_ring_shadow.restype = lib.rt_ring_finish.restype = i
        lib.rt_error_string.argtypes = [i]
        lib.rt_error_string.restype = ctypes.c_char_p
    # a kernel's mangled name holds a hash of its file's path in the
    # anonymous namespace, which differs between the two builds
    def plain(text):
        return re.sub(r"_GLOBAL__N__\w*?_ring_shade_cu_[0-9a-f]+", "", text)

    bodies = {}
    for _, sass in forms.values():
        for m in re.finditer(r"Function : (\S+)", sass):
            if "ring_shadow" in m.group(1) or "ring_finish" in m.group(1):
                bodies.setdefault(plain(m.group(1)), []).append(
                    [(op, plain(text)) for _, op, text in
                     cs.sass_function(sass, m.group(1))])
    for fn, found in sorted(bodies.items()):
        print(f"{fn}: {len(found[-1])} instructions, the same SASS in the "
              f"parent's library and the port's: "
              f"{len(found) == 2 and found[0] == found[1]}")

    device = torch.device("cuda", 0)
    n = 1 << 21
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def device_ms(fn, before):
        out = []
        for _ in range(7):
            before()
            torch.cuda.synchronize()
            torch.cuda._sleep(cs.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end))
        return min(out)

    lanes_p = [t.to(torch.int32)
               for t in cs.pixel_lanes(1024, n // 2, 2, 1, device)]
    lit = build_scene(dsl.parse(cs.LIT_MIRROR), device=device)
    cases = (("ring_finish, linear field",
              make_sphere_field(1000, mix_materials=False, device=device),
              lanes_p),
             ("ring_finish, mixed field",
              make_sphere_field(1000, mix_materials=True, device=device),
              lanes_p),
             ("ring_shadow, lit mirror", lit,
              [t.to(torch.int32)
               for t in cs.random_lanes(lit.spec, n, cs.SEED, device)]))
    times = {label: {f: [] for f in forms} for label, _, _ in cases}
    for label, sc, lanes in cases:
        spec = sc.spec
        with ring.ring_context(sc.data, spec, Mesh(device)) as st:
            ctx = intersect.ring_ctx()
            state = ring_shade.start_reference(st, spec, *lanes, 0)
            ro, rd = state.rays()
            t, obj, hit = ring.ring_closest_hit_local(
                ctx.shard, ctx.n_sph_pad, ro, rd, ctx.mesh)
            rows = ring.ring_gather_rows_reference(ctx.mat_rows, obj,
                                                   ctx.mesh)
            saved = [x.clone() for x in state]

            def restore():
                for a, b in zip(state, saved):
                    a.copy_(b)

            if label.startswith("ring_shadow"):
                want = [ring_shade.shadow_reference(st, spec, state, t, hit,
                                                    rows)]
                got = {}

                def run(got=got):
                    got["q"] = ring_shade.ring_shadow(st, spec, state, t,
                                                      hit, rows)

                def result(got=got):
                    return [got["q"]]
            else:
                restore()
                ring_shade.finish_reference(st, spec, state, t, hit, rows,
                                            None)
                want = [x.clone() for x in state]

                def run():
                    ring_shade.ring_finish(st, spec, state, t, hit, rows,
                                           None)

                def result():
                    return list(state)
            for f in list(forms) + list(forms)[::-1]:
                ring_shade._lib_ready = forms[f][0]
                restore()
                run()
                same = all(torch.equal(a, b) for a, b in zip(result(), want))
                if not same:
                    raise AssertionError(f"{f}: {label} differs from its "
                                         f"twin")
                times[label][f].append(device_ms(run, restore))
        ring_shade._lib_ready = None
        print(f"{label}: equal to its twin to the bit in every form; device "
              + "; ".join(f"{f} {min(v):.4f} ms (runs "
                          + ", ".join(f"{x:.4f}" for x in v) + ")"
                          for f, v in times[label].items())
              + f"; on {smi}", flush=True)


def ring_variants(parent: str | None, smi: str) -> None:
    """The forms of ring_start and ring_rows in turns (forward, then
    backward), bare launches on prepared inputs, each held to its plain
    twin to the bit, with registers and global loads and stores."""
    import ctypes

    import chip_smoke as cs

    from raytrace_tpu_torch.ops import _build, intersect, rng
    from raytrace_tpu_torch.parallel import ring
    from raytrace_tpu_torch.parallel.mesh import Mesh
    from raytrace_tpu_torch.render import megakernel, ring_shade
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    device = torch.device("cuda", 0)
    n = 1 << 21
    sc = make_sphere_field(1000, mix_materials=False, device=device)
    spec = sc.spec
    wide = cs.pixel_lanes(1024, n // 2, 2, 1, device)
    narrow = [t.to(torch.int32) for t in wide]
    p, i = ctypes.c_void_p, ctypes.c_int

    # every form's library, built and loaded beside the others
    libs = []
    for name, base, edits in ring_forms(parent):
        patched_sources(base=base, edits=edits)
        lib = _build.load(_build.KERNEL_RING)
        with open(os.path.join(_build.CSRC_DIR, "ring_shade.cu")) as f:
            typed = "int id_bytes" in f.read()
        lib.rt_ring_start.argtypes = (
            [p] * 4 + ([i] if typed else []) + [p, i, ctypes.c_uint32]
            + [p] * 4 + [ctypes.c_longlong, p])
        lib.rt_ring_rows.argtypes = [p, i, i, p, p, ctypes.c_longlong, p]
        lib.rt_ring_start.restype = lib.rt_ring_rows.restype = i
        path = _build.library_path(_build.KERNEL_RING)
        libs.append((name, lib, typed, resource_registers(path),
                     cs.cuobjdump_sass(path)))
    patched_sources()

    with ring.ring_context(sc.data, spec, Mesh(device)) as st:
        ctx = intersect.ring_ctx()
        header = megakernel.pack_header(st, spec)
        twin = ring_shade.start_reference(st, spec, *wide, 0)
        ro, rd = twin.rays()
        _, obj, _ = ring.ring_closest_hit_local(ctx.shard, ctx.n_sph_pad, ro,
                                                rd, ctx.mesh)
        assert obj.dtype == torch.int32
        rows_all = ctx.mat_rows.detach().contiguous()
        halves = ring.shard_object_table(megakernel.kernel_rows(
            intersect.object_table(sc.data, spec)), 2)
        shards = {"k = 1": rows_all, "k = 2, shard 0": halves[0].contiguous()}
        fill = torch.full((n, 24), -1.0, device=device)
        rows_want = {k: ring._select_rows(sh, obj, 0, fill)
                     for k, sh in shards.items()}
        print(f"ring_rows at k = 2, shard 0 ({halves.shape[1]} rows): "
              f"{float((obj < halves.shape[1]).float().mean()):.4f} of the "
              f"lanes take a row")
    stream = torch.cuda.current_stream().cuda_stream

    def check(rc, what):
        if rc != 0:
            raise RuntimeError(f"{what} failed with CUDA error {rc}")

    cases = {}
    for name, lib, typed, _, _ in libs:
        state = ring_shade.ring_lanes(spec, n, device)
        tail = [header.data_ptr(), 0, 0, state.node.data_ptr(),
                state.acc.data_ptr(), state.live.data_ptr(),
                state.sp.data_ptr(), n, stream]

        def start(ids, lib=lib, typed=typed, tail=tail):
            words = ring_shade.start_ids(*ids)[0] if typed else ids
            width = [words[0].element_size()] if typed else []

            def call(words=words):
                check(lib.rt_ring_start(*(t.data_ptr() for t in words),
                                        *width, *tail), "rt_ring_start")
            return call

        forms = {"ring_start, int32 ids": (start(narrow), state)}
        if typed:
            forms["ring_start, int64 ids"] = (start(wide), state)
        else:
            # the parent's wrapper: its conversion of each id, then the
            # kernel
            def converted(lib=lib, tail=tail):
                ids = [(t.to(torch.int64) & rng.MASK).to(torch.int32)
                       .contiguous() for t in wide]
                check(lib.rt_ring_start(*(t.data_ptr() for t in ids), *tail),
                      "rt_ring_start")
            forms["ring_start, int64 ids"] = (converted, state)
        for k, sh in shards.items():
            out = fill.clone()
            forms[f"ring_rows, {k}"] = (
                lambda lib=lib, sh=sh, out=out: check(lib.rt_ring_rows(
                    sh.data_ptr(), 0, sh.shape[0], obj.data_ptr(),
                    out.data_ptr(), n, stream), "rt_ring_rows"), out)
        cases[name] = forms

    # each form against its twin, to the bit
    for name, forms in cases.items():
        for label, (fn, got) in forms.items():
            if label.startswith("ring_start"):
                got.live.zero_()
                fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in
                           zip(got[:4], twin[:4]))
            else:
                got.copy_(fill)
                fn()
                torch.cuda.synchronize()
                same = torch.equal(got, rows_want[label.split(", ", 1)[1]])
            print(f"  {name}: {label} equal to its twin to the bit: {same}")
            if not same:
                raise AssertionError(f"{name}: {label} differs from its twin")

    times = {name: {label: [] for label in forms}
             for name, forms in cases.items()}
    order = list(cases) + list(cases)[::-1]
    for name in order:
        for label, (fn, _) in cases[name].items():
            times[name][label].append(min(cs.ms_per_launch(fn, 3, 20)
                                          for _ in range(3)))
    # the kernels by a part of their mangled names: ring_start's 32- and
    # 64-bit instances, and the parent's one
    insts = ("ring_rows_kernel", "ring_start_kernelIjE",
             "ring_start_kernelIyE", "ring_start_kernelEPKj")
    for name, lib, typed, regs, sass in libs:
        found = {inst: (next((r for fn, r in regs.items() if inst in fn),
                             None), global_memory_ops(sass, inst))
                 for inst in insts}
        print(f"{name}: " + "; ".join(
            f"{inst} {regs} registers, global loads and stores {mem}"
            for inst, (regs, mem) in found.items() if mem)
            + f"; on {smi}")
        print("  " + "; ".join(f"{label} {min(v):.4f} ms (runs "
                               f"{', '.join(f'{x:.4f}' for x in v)})"
                               for label, v in times[name].items()),
              flush=True)
    if parent is not None:
        ring_neighbours(libs, smi)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("k1", "k4", "tree", "fold", "fused",
                                       "ring"))
    ap.add_argument("--parent", default=None,
                    help="a checkout of the parent tree, for K1's steps, "
                         "K4's and the ring kernels' parent forms and the "
                         "fused kernels' hashes")
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

    if args.only == "ring":
        ring_variants(args.parent, smi)
        print(f"on {smi}")
        return 0
    if args.only == "fused":
        if args.parent is None:
            raise SystemExit("--only fused needs --parent")
        fused_against_parent(args.parent, smi)
        print(f"on {smi}")
        return 0
    if args.only in (None, "k1"):
        k1_variants(args.parent, smi, args.sass_dir)
    if args.only in (None, "k4"):
        k4_variants(args.parent, smi, args.sass_dir)
    if args.only in ("k1", "k4"):
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
