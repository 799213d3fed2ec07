"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from ``raytrace_tpu_torch/csrc``
(one nvcc each, in parallel) and holds each against its plain PyTorch
version on the card. The linear kernel: on
``examples/cornell_indirect.txt``, which it renders at 512x512 with 16
samples per pixel through the port's CLI on ``--device cuda`` and times
at 2,097,152 lanes per launch, and on a scene of exact ties, where its
winners must equal the plain version's on every lane (phases 3-5); phase
5 also prints its SASS by kind (``cuobjdump -sass``), the instructions a
lane issues by that count and the time they take at the card's issue
rate (the issue figure), beside a bound recounted from every operation a
lane needs; phases 9 and 17 print the same for its lit and skybox
instances. Then on a lit mirror scene with depth of field (phase 6). The
tree kernel: on ``examples/materials_showcase.txt``, on a 4-sample
IndirectPhong scene (1,365 nodes per lane) and on two scenes that take
its two largest stack sizes (phase 7), then on the lanes of the CLI's
launch of the showcase, which the CLI then renders at its own 640x400,
64 x 4 samples per pixel (phase 8); both kernels with lights are timed
at 2,097,152 lanes per launch (phase 9). Large scenes, the procedural
sphere fields of 1,006 and 4,006 objects: the scan kernel against its
plain version on camera rays and on random rays (phase 10); the large
instances of the linear and tree kernels, which fold over the scene's
tables, against the plain path, also with a point light, and the split
path (the plain chain with the scan kernel) against the fused kernel
(phase 11); the CLI's own launch of the 1,006-object linear and mixed
fields (4,194,304 lanes) against the plain path, then the CLI's renders
of them at 1024x1024 with 4 samples per pixel (phase 12); timing at
2,097,152 lanes per launch, where each timed launch of a large instance,
of the scan kernel and of the split path is again held against its plain
run (phase 13). Skybox scenes, with six faces of 1024x1024 (one of
512x768) made from a seed and written as BMPs beside the scene files:
the skybox kernel alone against its plain version on 2,097,152 random
directions and on the primary-ray directions of the cornell sky launch,
also after the cube changed in place (the linear kernel's sky instance
too), with its SASS loads and the library's yardstick, one grid_sample
over the six faces stacked (phase 14; phase 2 prints what the faces
packed for the lookup take and what packing them costs); the sky
instances of both render kernels, small and large, against the plain
path on random lanes and on the CLI's own launch lanes (phase 15); the
CLI on the four skybox scenes (phase 16); timing at 2,097,152 lanes per
launch, with the solid scenes again beside them (phase 17). Gradients:
forward through each kernel and backward through its plain version
against the plain version alone, then two fits at 256x256 with 4 samples
per pixel, which recover a perturbed diffuse row and ambient row with
Adam at betas 0.8/0.99, and the same fits with ``fit``'s default
optimiser beside them (phase 18). Multi-device, with one rank: the CLI
with ``--shard`` on cornell and the showcase (the same BMP as without
it), with ``--shard-objects`` on the 1,006-object fields at 256x256 with
4 samples per pixel, through the ring instances of the linear and tree
kernels (``ring_shade.cu``: a node of every lane a round, the scan kernel
answering each round's queries; the expected counts, no fused render
kernel and no call of the plain version on the card), held to the fused
kernels' image and timed per image; a ring render under the sky, whose
misses the ring's sky instance looks up inline; the ring instances
against their plain twin (``ring_shade_reference``) on the linear and
mixed fields, the lit mirror scene, the open field under the sky and a
65-sample tree at 262,144 lanes (stacks of 65 entries); a round of each
instance timed at 2,097,152 lanes beside its bound, the round's scan
kernel and the rows' gather (``ring_start`` and ``ring_rows`` also as bare
launches, and ``ring_start`` on int64 ids too); the ring's step (the scan
kernel on a shard) on the 4,006-object field whole and halved, and the
shard's build;
the ring's gradients at k = 1 on 65,536 camera rays of the 1,006-object
field (t through ``make_ring_intersector`` in the geometry and the rays,
the hit records through ``ring_closest_hit`` in every per-object leaf),
their forwards through the scan kernel and ``ring_rows``, against the
dense path's, each backward timed (phase 19; phases 11 and 13 hold the
split path, a one-shard ring, to the fused large instances and time it
beside its scan kernel launches).
Two ranks on the one card (gloo), this script started twice under the
environment protocol: the multi-process CLI's BMP against the
one-process CLI's, byte for byte; the ring at k = 2 against k = 1, to
the bit, in intersection and in renders of the linear field and of the
mixed one (the tree instance, whose ranks agree on the rounds by a MAX
all-reduce); the sharded fitting step
against ``loss_and_grad``; the ring's hand-off timed; the ring's
gradients at k = 2 against the dense path's; ``render_image_sharded`` and
``render_image_ring`` with a checkpoint at a path of each rank's own,
stopped after the first launch group and resumed, to the bit, rank 0's
file the only one, and a resume with another seed refused on both ranks
(phase 20). Deep
fan-out trees (phase 21): the tree kernel's 128- and 256-entry stacks
and its slab (the stack in device memory) on 65-, 129- and 300-sample
IndirectPhong scenes at max_depth 0, solid, under the sky and in the
1,006-object field, against the plain version bit for bit, the trees of
the local stacks also through the slab; each solid scene timed at
262,144 random lanes beside its bound, its registers, stack frame and
local memory, the slab and the local stack in turns (and so a 16-sample
tree at max_depth 4, whose bound is counted on its live nodes,
``work.path_work``); then the CLI on a scene per instance at the fixed
max_depth 4. The benchmark harness and the entry points (phase 22,
under 90 s): ``raytrace_tpu_torch/bench.py`` in this process, its default
mode (cornell at 1024x1024, 16 samples, 2,097,152 lanes a launch, whose
launch must take 0.9-1.6x phase 5's wrapper call), ``--large 1000`` and
``--large 1000 --mix`` (the 1,006-object fields, fused against split,
each chain's kernel counted) and ``--shard`` with one rank, each mode's
JSON line printed on its own; ``entry()``'s forward (K1, one launch)
against its plain version, on every pixel of its 64x64 image under the
K1 rule and on its 128-pixel example arguments under the rule's part for
lanes; ``dryrun_multichip(2)``, run by the two ranks of phase 20, held to
one process's loss and image. Phase 1 prints what the
runtime reports of the card and its published peaks (the bounds'
figures, ``utils/gpu_info.py``), phase 2 the fold's staging limit
derived from them and the staging of each field; phase 4 renders with
``--profile`` and checks that the trace names K1's kernel, and that a
one-rank sharded step's trace names the five phase ranges. The
tree kernel is held to the plain
version bit for bit in each of its stack sizes; the table fold with
the table staged in shared memory (1,006 objects) and read from device
memory (4,006), on camera rays, which every thread folds for itself, and
on rays that part, which a warp folds one at a time, through the scan
kernel and through both render kernels' large instances; phases 9 and 13
print what the paths need (live nodes per lane and the largest of a
warp; sphere chunks a ray enters and the union over a warp, per depth)
beside the times. Each CLI render checks that it went through its
kernel; a second render of it runs under the profiler, and the device
time of that run over that run's own seconds is the share the device was
busy. Phase headers carry the seconds since the start. Every phase
succeeds or raises; the last line is ``{"ok": true, ...}`` only when all
of them passed. Without a CUDA device it fails at once. It imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import io
import json
import math
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
# the operation counts and the bounds made from them, the card's name and
# the device's busy time (moved from this script, unchanged): the first
# import of the port, which fails where the script stands alone
from raytrace_tpu_torch.utils.flops import (  # noqa: E402
    FLOPS_SKY, SKY_TEXEL_BYTES, bound, k1_bound, render_bound, scan_counts)
from raytrace_tpu_torch.utils.gpu_info import H100_SXM, nvidia_smi  # noqa: E402
from raytrace_tpu_torch.utils.profiling import (  # noqa: E402
    device_busy_ms, is_range)
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
# IndirectPhong samples of the scenes at max_depth 0 (beside that floor)
# whose DFS stacks take the tree kernel's deep instances: 65 entries (of
# 128), 129 (of 256) and 300 (the slab); the plain walk visits every node
# of the full tree, 66, 130 and 301 a lane, and keeps every child of the
# root, some 170 B a lane and child: at 2,097,152 lanes it takes 12, 37
# and 163 s, so these trees are timed at 262,144
DEEP_SAMPLES = (65, 129, 300)
DEEP_LANES = 1 << 18
# the ring instances' deep tree: IndirectPhong samples of the sphere at
# max_depth 0 (stacks of 65 entries, 3.4 KB a lane) and its lanes
RING_DEEP_SAMPLES = 65
RING_DEEP_LANES = 1 << 18
# and the scenes the CLI renders at the fixed max_depth 4: stacks of 76,
# 256 and 316 entries.  The first is that sphere with 16 samples over the
# mirror floor.  A child ray that leaves a sphere at a grazing angle may
# hit it again (PERF.md, §6), and its m children may too, so a sphere's
# tree at max_depth 4 grows with m to the fourth power where m of those
# hits are likely: at 52 samples a 8,192-lane launch runs for minutes.
# The two wider stacks take the samples on the floor, whose children
# cannot hit it again, under a matte sphere (no child): m + 1 nodes a lane
DEEP_CLI_SPHERE = (16,)
DEEP_CLI_FLOOR = (52, 64)
INDIRECT_FLOOR = LIT_MIRROR.replace(
    """material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8""",
    """material: IndirectPhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0,0,0) exponent: 1 samples: SAMPLES""").replace(
    "specular: rgb(0.4,0.4,0.4) exponent: 16", "specular: rgb(0,0,0) "
    "exponent: 16")
# the CLI's image of them: width, height, samples per pixel
DEEP_CLI_IMAGE = (64, 64, 2)

# kernel vs plain version: Monte-Carlo paths fork after a near-tie when
# two roundings differ by an ulp, so a few lanes may disagree by a lot;
# the JAX package misses the per-lane rule against itself by 0.3% of lanes
LANE_RTOL = 1e-4          # |d| <= LANE_RTOL * max(1, |ref|) per channel
MIN_LANES_OK = 0.99       # ... on at least this share of the lanes
MEAN_RTOL = 1e-3          # per-channel means


# SASS opcodes by kind, for sass_loops
_SASS_CONTROL = {"BRA", "BRX", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "JMP",
                 "JMX", "BREAK", "WARPSYNC", "BPT", "YIELD", "KILL", "BAR"}
_SASS_INT = {"LOP3", "SHF", "LEA", "POPC", "FLO", "BMSK", "PRMT", "SEL",
             "SGXT", "BREV", "VIADD", "VIMNMX"}


def sass_kind(op: str) -> str:
    """The kind of a SASS opcode: shared load, MUFU, control, integer,
    float or other."""
    base = op.split(".")[0]
    if base == "LDS":
        return "lds"
    if base == "MUFU":
        return "mufu"
    if base in _SASS_CONTROL:
        return "control"
    if base in ("I2F", "F2I", "I2FP", "F2IP", "F2F", "FRND"):
        return "float"
    if base in _SASS_INT or (base.startswith("I") and base != "IDE"):
        return "int"
    if base.startswith("F") or base.startswith("H"):
        return "float"
    return "other"


def sass_function(sass: str, name: str) -> list:
    """The (address, opcode, text) of each instruction of the function
    whose mangled name holds ``name``, in ``cuobjdump -sass`` output; NOPs
    left out."""
    body, inside, labels = [], False, {}
    pending = []
    for line in sass.splitlines():
        if "Function :" in line:
            inside = name in line.split("Function :")[1]
            continue
        if not inside:
            continue
        lab = re.match(r"\s*(\.L_x_\d+):", line)
        if lab:
            pending.append(lab.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if not m:
            continue
        addr = int(m.group(1), 16)
        for lab in pending:
            labels[lab] = addr
        pending = []
        text = m.group(2).strip()
        op = re.sub(r"^@!?U?P[T0-9]+\s+", "", text).split()[0]
        if op != "NOP":
            body.append((addr, op, text))
    return [(a, op, re.sub(r"`\((\.L_x_\d+)\)",
                           lambda m_: hex(labels.get(m_.group(1), -1)), t))
            for a, op, t in body]


def sass_loops(sass: str, name: str):
    """The loops of one kernel instance in its SASS: for each backward
    branch, the addresses [target, branch], merged per target; for each
    loop the counts by kind of the instructions that lie in it and in no
    loop inside it, and its parent.  Returns (instructions, loops), loops
    a list of dicts sorted by start."""
    body = sass_function(sass, name)
    if not body:
        raise AssertionError(f"no SASS for {name}")
    ends = {}
    for addr, op, text in body:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", text)
        if op.startswith("BRA") and m and int(m.group(1), 16) <= addr:
            tgt = int(m.group(1), 16)
            ends[tgt] = max(ends.get(tgt, 0), addr)
    loops = sorted(({"start": a, "end": b} for a, b in ends.items()),
                   key=lambda l: (l["start"], -l["end"]))
    for i, lp in enumerate(loops):
        outer = [j for j, o in enumerate(loops) if j != i
                 and o["start"] <= lp["start"] and lp["end"] <= o["end"]
                 and (o["end"] - o["start"]) > (lp["end"] - lp["start"])]
        lp["parent"] = min(outer, key=lambda j: loops[j]["end"]
                           - loops[j]["start"]) if outer else None
        lp["counts"], lp["text"] = {}, []
    top = {}
    for addr, op, text in body:
        inner = [j for j, lp in enumerate(loops)
                 if lp["start"] <= addr <= lp["end"]]
        j = min(inner, key=lambda j: loops[j]["end"] - loops[j]["start"]) \
            if inner else None
        counts = top if j is None else loops[j]["counts"]
        kind = sass_kind(op)
        counts[kind] = counts.get(kind, 0) + 1
        counts["all"] = counts.get("all", 0) + 1
        if j is not None:
            loops[j]["text"].append(text)
    return top, loops


def k1_issue(sass: str, name: str, spec, work: dict):
    """The instructions a lane of the linear kernel issues, estimated from
    its SASS: the loop whose body derives a child's stream (0xbb67ae85) is
    the node loop, run ``visits`` times a lane; the loops inside it run
    once per sphere (a body with MUFU.RSQ, the square root, and no
    MUFU.RCP), once per plane (MUFU.RCP, the division, and no MUFU.RSQ),
    once per object (both: a loop over both kinds) or once per light (a
    loop with loops inside); code outside the node loop runs once.  Every
    instruction of a body counts on every trip, those that a branch
    skips included, so this is an upper estimate.  A loop inside a loop
    body that fits none of these (a slow path for huge arguments) counts
    0.  Returns (instructions per lane, node-loop report)."""
    top, loops = sass_loops(sass, name)
    live = spec.live_objects()
    n_sph = sum(spec.shape_type[i] == 0 for i in live)
    nodes = [i for i, lp in enumerate(loops)
             if any("0xbb67ae85" in t for t in lp["text"])]
    if not nodes:
        raise AssertionError(f"{name}: no node loop in the SASS")
    node = max(nodes, key=lambda i: loops[i]["start"])

    def children(i):
        return [j for j, lp in enumerate(loops) if lp["parent"] == i]

    def trips(j):
        if children(j):
            return spec.n_lights
        text = " ".join(loops[j]["text"])
        rsq, rcp = "MUFU.RSQ" in text, "MUFU.RCP" in text
        return (len(live) if rsq and rcp else n_sph if rsq
                else len(live) - n_sph if rcp else 0)

    def per_trip(i):
        return loops[i]["counts"].get("all", 0) + sum(
            trips(j) * per_trip(j) for j in children(i))

    def kinds(i):
        out = dict(loops[i]["counts"])
        for j in children(i):
            for k, c in kinds(j).items():
                out[k] = out.get(k, 0) + trips(j) * c
        return out

    # everything outside the node loop once: the loops that hold it, and
    # the code around them
    outside = top.get("all", 0) + sum(
        lp["counts"].get("all", 0) for i, lp in enumerate(loops)
        if lp["end"] - lp["start"] > loops[node]["end"] - loops[node]["start"]
        and lp["start"] <= loops[node]["start"])
    per_lane = outside + work["visits"] * per_trip(node)
    report = {"node_body": loops[node]["counts"],
              "node_executed": {k: round(c, 1) for k, c in kinds(node).items()},
              "inner_loops": [{"trips": trips(j), **loops[j]["counts"]}
                              for j in children(node)],
              "outside": outside}
    return per_lane, report


FACES = ("px", "nx", "py", "ny", "pz", "nz")
# each face's (height, width): one smaller than the others, so that the
# padded cube holds faces of two sizes
FACE_SIZES = ((1024, 1024), (1024, 1024), (1024, 1024), (512, 768),
              (1024, 1024), (1024, 1024))
SKY_BACKGROUND = "SkyboxBackground { " + " ".join(
    f'{n}: load("sky/{n}.bmp")' for n in FACES) + " }"


def write_sky_faces(directory: str, seed: int) -> None:
    """Six sRGB faces from a seed, smooth gradients plus noise, written as
    BMPs (the port's own writer) into ``directory``/sky."""
    from raytrace_tpu_torch.io.bmp import write_bmp

    rs = np.random.RandomState(seed)
    os.makedirs(os.path.join(directory, "sky"))
    for name, (h, w) in zip(FACES, FACE_SIZES):
        y, x = np.mgrid[0:h, 0:w]
        ramp = np.stack([x / (w - 1), y / (h - 1), 1.0 - x / (w - 1)], -1)
        img = 0.15 + 0.6 * ramp * rs.uniform(0.4, 1.0, 3) + 0.15 * rs.rand(
            h, w, 3)
        write_bmp(os.path.join(directory, "sky", f"{name}.bmp"),
                  (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8))


def under_the_sky(text: str, open_planes=()) -> str:
    """The scene text with the skybox in place of its solid background,
    and without the planes through ``open_planes`` (their ``point:`` as
    written), which would keep rays from the sky."""
    text, n = re.subn(r"SolidColorBackground \{[^}]*\}", SKY_BACKGROUND, text)
    if n != 1:
        raise AssertionError("no solid background to replace")
    for point in open_planes:
        text, n = re.subn(
            r"\{\s*bounds: Plane \{ point: " + re.escape(point)
            + r"[^}]*\}\s*material: \w+ \{[^}]*\}\s*\}", "", text)
        if n != 1:
            raise AssertionError(f"no plane through {point}")
    return text


# the planes taken out to open scenes to the sky: cornell keeps its floor
# and its two spheres (its walls are infinite planes, and any two of them
# that face each other close the box); the sphere fields keep their floor
OPEN_BOX = ("(0, 0, -4)", "(0, 7, 0)", "(-3.5, 0, 0)", "(3.5, 0, 0)")
OPEN_FIELD = ("(0, 30, 0)", "(-30, 0, 0)", "(30, 0, 0)")
SKY_SCENES = ("cornell", "showcase", "field_linear", "field_mixed")


def sky_scene_text(name: str) -> str:
    """The skybox scene ``name`` of SKY_SCENES: cornell opened, at
    1024x1024 x 16 aa; the showcase; the 1,006-object fields, linear and
    mixed, opened; each under the sky of ``write_sky_faces``."""
    from raytrace_tpu_torch.scene.procedural import sphere_field_source

    if name == "cornell":
        with open(SCENE) as f:
            return under_the_sky(f.read(), OPEN_BOX).replace(
                "width: 512", "width: 1024").replace(
                "height: 512", "height: 1024").replace(
                "antialias: 256", "antialias: 16")
    if name == "showcase":
        with open(SHOWCASE) as f:
            return under_the_sky(f.read())
    return under_the_sky(sphere_field_source(
        1000, mix_materials=name == "field_mixed"), OPEN_FIELD)


def sky_random_directions(n: int, seed: int, device) -> torch.Tensor:
    """``n`` unit directions (N, 3) from a seed: random ones, after 1,024
    exact ties of x and y and 1,024 of y and z for the largest component
    (black), 1,024 axis-aligned directions and 1,024 with a zero
    component."""
    rs = np.random.RandomState(seed)
    dirs = rs.normal(0, 1, (n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:1024, 1] = dirs[:1024, 0]
    dirs[:1024, 2] = 0.25 * dirs[:1024, 0]
    dirs[1024:2048, 2] = -dirs[1024:2048, 1]
    dirs[1024:2048, 0] = 0.25 * dirs[1024:2048, 1]
    dirs[2048:3072] = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 1024)] * (
        rs.choice([-1.0, 1.0], 1024)[:, None].astype(np.float32))
    dirs[np.arange(3072, 4096), rs.randint(0, 3, 1024)] = 0.0
    return torch.from_numpy(dirs).to(device)


def sky_coherent_directions(sky, device) -> torch.Tensor:
    """The primary-ray directions (N, 3) of the CLI's launch of the skybox
    scene ``sky``, in the launch's pixel order: neighbouring directions
    are neighbours on a face, as a render's misses out of an open box."""
    from raytrace_tpu_torch.render.integrator import primary_rays

    launch, _ = cli_launch_lanes(sky.spec, device)
    _, rd, _, _ = primary_rays(sky.data, sky.spec, *launch.expand(), SEED)
    return torch.stack(list(rd), dim=1).contiguous()


def sky_library_grid(cube: torch.Tensor, face_sizes, rd: torch.Tensor):
    """The first half of ``sky_library_call``: the face choice and the UV
    as PyTorch elementwise operations, into the (1, 1, N, 2) grid of
    ``grid_sample`` over the six faces stacked into a (1, 3, 6 H, W) image,
    each face's rows offset by face * H and its coordinates scaled to its
    own size; and the directions that have a dominant axis."""
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]
    ax, ay, az = dx.abs(), dy.abs(), dz.abs()
    x_dom = (ax > az) & (ax > ay)
    y_dom = (ay > ax) & (ay > az)
    z_dom = (az > ax) & (az > ay)
    face = torch.where(x_dom, torch.where(dx > 0, 0, 1), torch.where(
        y_dom, torch.where(dy > 0, 2, 3), torch.where(dz > 0, 4, 5)))
    u = torch.where(x_dom, -dz, dx) / torch.where(
        x_dom, dx, torch.where(y_dom, ay, dz))
    v = torch.where(y_dom, dz, -dy) / torch.where(
        x_dom, ax, torch.where(y_dom, dy, az))
    sizes = torch.tensor(face_sizes, dtype=torch.float32, device=rd.device)
    fh, fw = sizes[face, 0], sizes[face, 1]
    hmax, wmax = cube.shape[1], cube.shape[2]
    x = (u * 0.5 + 0.5).clamp(0.0, 1.0) * (fw - 1.0)
    y = (v * 0.5 + 0.5).clamp(0.0, 1.0) * (fh - 1.0) + face * hmax
    grid = torch.stack([x * (2.0 / (wmax - 1)) - 1.0,
                        y * (2.0 / (6 * hmax - 1)) - 1.0], -1)[None, None]
    return grid, x_dom | y_dom | z_dom


def sky_grid_sample(stacked: torch.Tensor, grid: torch.Tensor):
    """One bilinear ``grid_sample`` of the stacked faces, align_corners and
    border padding: (3, 1, N) colors."""
    return torch.nn.functional.grid_sample(
        stacked, grid, mode="bilinear", padding_mode="border",
        align_corners=True)[0]


def sky_library_call(cube: torch.Tensor, face_sizes, rd: torch.Tensor,
                     stacked: torch.Tensor) -> torch.Tensor:
    """The function of ``_skybox`` through the library
    (``sky_library_grid``, then ``sky_grid_sample`` over ``stacked``, the
    faces as one (1, 3, 6 H, W) image), ties black.  grid_sample forms
    its weights from coordinates normalised to the whole image, so it
    rounds them its own way."""
    grid, dom = sky_library_grid(cube, face_sizes, rd)
    out = sky_grid_sample(stacked, grid)[:, 0].t()
    return torch.where(dom[:, None], out, 0.0)


def k4_sass(sass: str) -> dict:
    """skybox_kernel's SASS (``cuobjdump -sass`` of its library): its
    instructions, its loads from memory by opcode (global, texture and
    constant), and its integer and float instructions."""
    body = sass_function(sass, "skybox_kernel")
    loads, kinds = {}, {}
    for _, op, _ in body:
        if op.split(".")[0] in ("LDG", "LD", "TEX", "TLD", "TLD4", "LDC",
                                "ULDC"):
            loads[op] = loads.get(op, 0) + 1
        kind = sass_kind(op)
        kinds[kind] = kinds.get(kind, 0) + 1
    return {"instructions": len(body), "loads": loads,
            "int": kinds.get("int", 0), "float": kinds.get("float", 0)}


# the linear kernel's three small instances, as their mangled names hold
# the template arguments <LIT, LARGE, SKY>
K1_INSTANCES = {"lean": "megakernel_linearILb0ELi0ELb0E",
                "lit": "megakernel_linearILb1ELi0ELb0E",
                "sky": "megakernel_linearILb0ELi0ELb1E"}

# exact ties: the plane z = -3 (object 0) and its copy (object 2) around
# the sphere at (0, 0, -4) of radius 1 (object 1), which the ray from the
# origin along -z meets at t = 3 as it meets the planes; the floor twice
# (3, 4); a sphere at (5, 0, 0) (5) before the plane x = 4 (6), which the
# ray from the origin along +x meets at t = 4.  Object k has the ambient
# color (k + 1) / 16 in red, so that at max_depth -1, where a lane's
# radiance is its winner's ambient color, the radiance names the winner.
TIES = ("{ objects: [ " + " ".join(
    f"{{ bounds: {b} material: PhongMaterial {{ diffuse: rgb(0.5,0.5,0.5) "
    f"specular: rgb(0,0,0) exponent: 1 ambient: rgb({(k + 1) / 16},0,0) }} }}"
    for k, b in enumerate((
        "Plane { point: (0, 0, -3) normal: (0, 0, 1) }",
        "Sphere { center: (0, 0, -4) radius: 1 }",
        "Plane { point: (0, 0, -3) normal: (0, 0, 1) }",
        "Plane { point: (0, -1, 0) normal: (0, 1, 0) }",
        "Plane { point: (0, -1, 0) normal: (0, 1, 0) }",
        "Sphere { center: (5, 0, 0) radius: 1 }",
        "Plane { point: (4, 0, 0) normal: (1, 0, 0) }"))) + """ ]
  lights: [ ]
  camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 2)
  background: SolidColorBackground { color: rgb(0, 0, 0) }
  options: { width: 32 height: 32 antialias: 2 }
}""")


def ambient_ids(rad_x: torch.Tensor) -> torch.Tensor:
    """The object ids behind radiance of TIES at max_depth -1; -1 where a
    lane missed."""
    return torch.round(rad_x * 16).long() - 1


def cuobjdump_sass(path: str) -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    tool = os.path.join(home, "bin", "cuobjdump")
    r = subprocess.run([tool if os.path.exists(tool) else "cuobjdump", "-sass",
                        path], check=True, capture_output=True, text=True,
                       timeout=300)
    return r.stdout


def ptxas_registers(log: str, instance: str):
    """The registers ptxas gave the kernel instance ``instance`` (a part
    of its mangled name), from the build's -v report; None without one
    (a library built by an earlier process)."""
    m = re.search(re.escape(instance) + r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used "
                  r"(\d+) registers", log)
    return int(m.group(1)) if m else None


def ptxas_frame(log: str, instance: str):
    """The stack frame (bytes) ptxas gave the kernel instance ``instance``,
    from the build's -v report; None without one."""
    m = re.search(re.escape(instance) + r"[^\n]*\n(?:[^\n]*\n)*?[^\n]*?(\d+) "
                  r"bytes stack frame", log)
    return int(m.group(1)) if m else None


@contextlib.contextmanager
def forced_slab(megakernel):
    """Every tree through the tree kernel's slab, whatever its stack: to
    check and time the slab where a local-memory stack is the instance."""
    own = megakernel.tree_instance
    megakernel.tree_instance = lambda cap: megakernel.TREE_SLAB
    try:
        yield
    finally:
        megakernel.tree_instance = own


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                        "--format=csv,noheader,nounits"], check=True,
                       capture_output=True, text=True, timeout=60)
    return float(r.stdout.strip().splitlines()[0]) * 1e6


def k1_report(label, instance, spec, n_lanes, work, ms, sass, log, smi):
    """Print what K1's instance ``instance`` (a key of K1_INSTANCES) issues
    on this launch beside its recounted bound and its time: the SASS of
    its node loop by kind, its registers, the instructions a lane issues
    (``k1_issue``) and the issue figure, those instructions over the
    card's 4 x 32 a clock per SM.  Returns the recounted bound as
    (ms, "operations" or "bytes")."""
    name = K1_INSTANCES[instance]
    per_lane, rep = k1_issue(sass, name, spec, work)
    hz = sm_clock_hz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    issue_ms = per_lane * n_lanes / (sms * 128 * hz) * 1e3
    b_ms, b_by, units = k1_bound(spec, n_lanes, work)
    print(f"    K1 {instance} ({label}): {ptxas_registers(log, name)} "
          f"registers; SASS of one node's body by kind {rep['node_body']}, "
          f"its inner loops {rep['inner_loops']}, executed per node "
          f"{rep['node_executed']}, {rep['outside']} outside the node loop; "
          f"{per_lane:.0f} instructions a lane (upper estimate), an issue "
          f"figure of {issue_ms:.4f} ms at {hz / 1e6:.0f} MHz on {sms} SMs; "
          f"recounted bound {b_ms:.4f} ms ({b_by}; by unit "
          f"{ {k: round(v, 4) for k, v in units.items()} }); time {ms:.4f} "
          f"ms, {b_ms / ms:.3f} of the bound, {issue_ms / ms:.3f} of the "
          f"issue figure; on {smi}")
    return b_ms, b_by


def trace_names(path: str) -> dict:
    """The event names of a Chrome trace that torch.profiler wrote, by
    category ("kernel": the device's kernels; "user_annotation": the
    record_function ranges)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for e in events:
        if "cat" in e and "name" in e:
            out.setdefault(e["cat"], set()).add(e["name"])
    return out


def compare(got, want, exact: bool = False, means: bool = True) -> dict:
    """Hold kernel radiance against the plain version's; raise if the
    tolerance above is missed, or with ``exact`` (the tree kernel, which
    is compiled without contraction) if any lane differs in any bit.
    ``means=False`` holds the lanes alone, for a launch too small for the
    means' bound: there one forked lane, which the lanes' budget allows,
    moves a mean by more than it."""
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
            and (not means or (mean_rel <= MEAN_RTOL).all())):
        raise AssertionError(f"kernel disagrees with the plain version: "
                             f"{stats}")
    if exact and stats["bit_equal"] != 1.0:
        raise AssertionError(f"the tree kernel is not bit-equal to the plain "
                             f"version: {stats}")
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


def cli_launch_lanes(spec, device, every: int = 1):
    """The CLI's first launch of a scene at its own settings, as the image
    loop hands it to the kernels: a ``megakernel.LaunchLanes`` of every
    ``every``-th pixel (int32 ids), the first aa samples that fit the
    CLI's lane budget and every lens sample.  Returns (the launch, aa
    samples per launch)."""
    from raytrace_tpu_torch.render.integrator import _s_p_launch
    from raytrace_tpu_torch.render.megakernel import LaunchLanes

    s_launch, p_launch = _s_p_launch(spec, spec.antialias, 1 << 22)
    if p_launch != spec.width * spec.height:
        raise AssertionError("the image no longer fits one launch")
    pix = torch.arange(0, p_launch, every, dtype=torch.int32, device=device)
    return LaunchLanes(pix % spec.width, pix // spec.width,
                       torch.arange(s_launch, dtype=torch.int32,
                                    device=device),
                       spec.cam_samples), s_launch


def compare_scan(got, want, quiet: bool = False) -> dict:
    """Hold the scan kernel's (t, id, hit) against the plain version's:
    ids and hits equal on every ray and t to the bit (the fold rounds every
    product and sum as the plain scan does)."""
    (t, gid, hit), (wt, wg, wh) = got, want[:3]
    same = (gid == wg) & (hit == wh)
    both = same & hit
    stats = {"rays": t.shape[0],
             "gid_mismatch": float(1 - (gid == wg).float().mean()),
             "hit_mismatch": float(1 - (hit == wh).float().mean()),
             "t_rel_err": float(((t - wt).abs() / wt)[both].max()),
             "max_abs_err": float((t - wt).abs()[both].max()),
             "hit_share": float(hit.float().mean())}
    if not quiet:
        print(f"  {stats}")
    if not (bool(same.all()) and torch.equal(t, wt)
            and bool(torch.isinf(t[~hit]).all())):
        raise AssertionError(f"scan kernel disagrees: {stats}")
    return stats


def once_ms(fn):
    """(ms, result) of one call, not warmed up."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


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


def device_ms(fn, reps: int, name_part: str = "", per_call: int = 1) -> float:
    """Device time per call of the CUDA kernels and copies whose name
    contains ``name_part``, from torch.profiler over ``reps`` calls.
    Only device rows count: a CPU operator's row repeats the device time
    of the kernels it launched.  With a name, a call makes ``per_call``
    such launches, and the reading stands only when the profiler recorded
    every one of them: a recording late in a long process may drop some
    of a run's records, and what is left then reads low or high.  NaN,
    with the reason printed, for a recording that is not whole; the
    CUDA-event time printed beside it stands alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for _ in (0, 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a recording made after large ones loses its first device
            # records (seen: 1 to 9 of them): trivial kernels go first
            for _ in range(64):
                scratch.add_(1.0)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = prof.key_averages()
        rows = [e for e in events
                if e.device_type == DeviceType.CUDA and name_part in e.key
                and not is_range(e)]
        us = sum(e.self_device_time_total for e in rows)
        seen = sum(e.count for e in rows)
        if us > 0 and (not name_part or seen == reps * per_call):
            return us / 1e3 / reps
        # not whole: say what it saw and record once more
        print(f"    (the profiler recorded {seen} of "
              f"{reps * per_call if name_part else 'the'} "
              f"{name_part or 'device'} launches in {len(events)} rows)")
    # not a fault of the port, and no reading either
    print("    (no whole recording from the profiler: nan below)")
    return float("nan")


def random_lanes(spec, n, seed, device):
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(a.astype(np.int64)).to(device) for a in (
        rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
        rs.randint(0, max(spec.antialias, 1), n),
        rs.randint(0, spec.cam_samples, n))]


def check_kernel(megakernel, kernel, data, spec, lanes, seed, label,
                 want=None) -> dict:
    """One wrapper call on the card, which must launch ``kernel`` once
    and nothing else, held against the plain version on the same lanes
    (``want``, when the caller has run it already); the tree kernel bit
    for bit."""
    if megakernel.kernel_for(spec) != kernel:
        raise AssertionError(f"{label}: the scene is not {kernel}'s")
    before = dict(megakernel.LAUNCHES)
    got = megakernel.radiance_lanes(data, spec, *lanes, seed)
    torch.cuda.synchronize()
    rose = {k: megakernel.LAUNCHES[k] - before[k] for k in megakernel.KERNELS}
    if rose != {k: int(k == kernel) for k in megakernel.KERNELS}:
        raise AssertionError(f"{label}: launches {rose}, not one of {kernel}")
    if want is None:
        want = megakernel.radiance_lanes_reference(data, spec, *lanes, seed)
    torch.cuda.synchronize()
    print(f"    {kernel} vs plain, {label}:")
    return compare(got, want, exact=kernel == megakernel.KERNEL_TREE)


def cli_render(cli, megakernel, kernel, scene_path, args, spec):
    """The CLI on --device cuda, with the launch counts set to 0 just
    before it; checks the BMP and the image; then the same render once
    more under the profiler: ``seconds_profiled`` in the record is that
    run's render seconds (the allocator now holds the launch's buffers, the
    profiler adds its own work), ``device_busy`` that same run's device
    time over them.  Returns (render_done log record, wall seconds,
    launches per kernel, BMP bytes)."""
    from raytrace_tpu_torch.io.bmp import row_stride

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out.bmp")
        log = os.path.join(tmp, "log.jsonl")
        for k in megakernel.LAUNCHES:
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
        busy = device_busy_ms(lambda: cli.main(
            [scene_path, "-o", os.path.join(tmp, "again.bmp"), *args,
             "--device", "cuda", "--log-json", log, "-q"]))
        with open(log) as f:
            again = [json.loads(x) for x in f if '"render_done"' in x]
        if len(again) != 2:
            raise AssertionError("the profiled render left no record")
        done["seconds_profiled"] = again[-1]["seconds"]
        done["device_busy"] = busy / (again[-1]["seconds"] * 1e3)
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


def ring_calls(spec, aa: int, k: int, max_lanes: int = 1 << 22) -> int:
    """The sample_pixels calls on one rank of a ring render of k ranks
    (render_image_ring), whose launches the ring kernels' lane state
    sizes."""
    from raytrace_tpu_torch.render import ring_shade
    from raytrace_tpu_torch.render.integrator import (_s_p_launch,
                                                      sample_groups)

    s_launch, p_launch = _s_p_launch(
        spec, aa, ring_shade.max_lanes(spec, max_lanes) * k)
    per_rank = -(-spec.width * spec.height // k)
    tiles = -(-per_rank // max(p_launch // k, 1))
    return sum(g for _, _, g in sample_groups(spec, aa, s_launch)) * tiles


def expected_ring_launches(spec, calls: int, rounds: int, k: int = 1) -> dict:
    """The launches of a ring render on one rank of k, per kernel of
    ``ring_shade.cu``, in all (``ring_shade``) and of the scan kernel,
    from its sample_pixels calls and their rounds (all calls together: a
    linear scene's call takes max_depth + 2, one where no material spawns
    a child, and a fan-out scene's as many as its longest lane has live
    nodes).  A call starts once; a round takes the ring's closest hit (k
    scan launches), the rows' ring (k ring_rows) and ring_finish; on a
    lit scene each round that shades (a linear scene's last does not)
    also ring_shadow and each light's shadow query round the ring (k scan
    launches)."""
    from raytrace_tpu_torch.ops import _build

    linear = spec.children_per_ray <= 1
    shaded = 0
    if spec.n_lights:
        shaded = (calls * min(rounds // calls, spec.max_depth + 1) if linear
                  else rounds)
    out = {"ring_start": calls, "ring_rows": k * rounds,
           "ring_shadow": shaded, "ring_finish": rounds,
           _build.KERNEL_SCAN: k * (rounds + spec.n_lights * shaded)}
    out[_build.KERNEL_RING] = sum(out[e] for e in _build.RING_KERNELS)
    return out


def ring_rounds(sc, calls: int, lanes=None, seed: int = 0) -> int:
    """The rounds of a ring render's ``calls`` sample_pixels calls: a
    linear scene's max_depth + 2 a call (1 without child slots); a
    fan-out scene's, rendered in one call of ``lanes``, the most live
    nodes of any lane, counted on the plain walk (``work.path_work``,
    65,536 lanes at a time)."""
    from raytrace_tpu_torch.render.work import path_work

    spec = sc.spec
    if spec.children_per_ray <= 1:
        return calls * (spec.max_depth + 2 if spec.children_per_ray else 1)
    if calls != 1:
        raise ValueError("a fan-out scene's rounds are counted for one call")
    step = 1 << 16
    return max(path_work(sc.data, spec, [t[i:i + step] for t in lanes],
                         seed)["most"]
               for i in range(0, lanes[0].shape[0], step))


# GPU cycles that the device spins before a bare launch's start event
# (torch.cuda._sleep, some 0.5 ms), so that the host's enqueue of the
# launch lies outside the events and they time the kernel alone
SPIN_CYCLES = 1_000_000
# the calls of a ring kernel's wrapper and bare launch that ring_round
# times, the best and the slowest of them reported
RING_REPS = 7


def ring_round(ringlib, ring_shade, intersect, sc, lanes, mesh) -> dict:
    """The first round of a ring render of ``lanes`` (every lane live),
    each ring kernel against its plain version on the same inputs (the
    state restored before each call): per kernel (``ring_start``,
    ``ring_rows``, on a lit scene ``ring_shadow``, ``ring_finish``) the
    CUDA-event ms of its wrapper's call, the best of ``RING_REPS`` with
    the slowest beside it, and of the plain one's, whether the two agree
    to the bit, the largest difference and the bytes the kernel must move,
    each input read once and each output written once: ``ring_start`` the
    four ids in, the node, sum, flag and stack pointer out (its bound also
    counts the primary rays' operations, ``flops.ring_start_bound``);
    ``ring_rows`` the id in and the 24-float row out a lane, and the
    shard's rows; ``ring_shadow`` the node, flag and answers (t, hit, the
    row) in, a query of 7 floats a light out; ``ring_finish`` the node and
    sum in and out, the answers and blocked bits, the flag, the stack
    pointer (a fan-out scene) and the entries pushed.  ``ring_start`` and
    ``ring_rows`` are also timed as bare launches of their entries in
    ``csrc/ring_shade.cu`` on inputs prepared outside the events (``bare``,
    best and slowest), with the host's time of the wrapper's call beside
    them (``host_ms``), ``ring_start`` also on the int64 ids that the image
    loop sends (``int64``).  The rows' gather also beside
    ``torch.index_select``, the same function on one rank
    (``library_ms``); and the round's scan kernel launch (``scan_ms``)."""
    from raytrace_tpu_torch.ops.vec import V3
    from raytrace_tpu_torch.render.megakernel import pack_header
    from raytrace_tpu_torch.scene.schema import (CAM_DEPTH_OF_FIELD,
                                                 LIGHT_DIRECTIONAL)
    from raytrace_tpu_torch.utils.flops import ring_start_bound

    spec = sc.spec
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    lib = ring_shade._lib()

    def timed(fn, spin=False):
        torch.cuda.synchronize()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    def best(fn, reps, before=lambda: None, spin=False):
        """(best, slowest) ms of ``reps`` calls; ``before`` runs ahead of
        each, outside its events."""
        out = []
        for _ in range(reps):
            before()
            out.append(timed(fn, spin))
        return min(out), max(out)

    def host_only(fn):
        """The host's ms of a wrapper call that launches without waiting,
        made while the device spins, so that it never waits on the
        device: the best of ``RING_REPS``."""
        out = []
        for _ in range(RING_REPS):
            torch.cuda.synchronize()
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        return min(out)

    def diff(a, b):
        """Largest difference of two float tensors, or of the floats of
        two node-word tensors."""
        if a.dtype == torch.int32:
            a, b = a[:10].view(torch.float32), b[:10].view(torch.float32)
        return float((a.float() - b.float()).abs().max())

    def entry(kernel, plain, got, want, nbytes, before=lambda: None,
              bare=None):
        """``bare``, where given, is the kernel's entry called on prepared
        inputs; ``got`` is compared after its calls."""
        ms, slowest = best(kernel, RING_REPS, before)
        out = {"ms": ms, "ms_slowest": slowest,
               "plain_ms": best(plain, 2, before)[0], "bytes": nbytes}
        if bare is not None:
            out["bare_ms"], out["bare_slowest"] = best(bare, RING_REPS,
                                                       before, spin=True)
            out["host_ms"] = host_only(kernel)
        pairs = list(zip(got, want))
        out["equal"] = all(torch.equal(a, b) for a, b in pairs)
        out["max_abs_err"] = max(diff(a, b) for a, b in pairs)
        return out

    def launch(fn, *args):
        """The entry ``fn`` of csrc/ring_shade.cu on the current stream."""
        stream = torch.cuda.current_stream().cuda_stream

        def call():
            rc = fn(*args, stream)
            if rc != 0:
                raise RuntimeError(f"{fn.__name__}: "
                                   f"{lib.rt_error_string(rc).decode()}")
        return call

    n = lanes[0].shape[0]
    n_light = spec.n_lights
    tree = spec.children_per_ray > 1
    out = {}
    with ringlib.ring_context(sc.data, spec, mesh) as st:
        ctx = intersect.ring_ctx()
        state = ring_shade.ring_start(st, spec, *lanes, 0)
        twin = ring_shade.start_reference(st, spec, *lanes, 0)
        header = pack_header(st, spec)
        dof = int(spec.cam_type == CAM_DEPTH_OF_FIELD)

        def start_bare(ids):
            words, width = ring_shade.start_ids(*ids)
            bare = ring_shade.ring_lanes(spec, n, header.device)
            return launch(lib.rt_ring_start, *(t.data_ptr() for t in words),
                          width, header.data_ptr(), dof, 0,
                          bare.node.data_ptr(), bare.acc.data_ptr(),
                          bare.live.data_ptr(), bare.sp.data_ptr(), n), bare

        # the stack's entries are written before they are read: only the
        # node, sum, flag and stack pointer are made
        call, bare = start_bare(lanes)
        out["ring_start"] = entry(
            lambda: ring_shade.ring_start(st, spec, *lanes, 0),
            lambda: ring_shade.start_reference(st, spec, *lanes, 0),
            [*state[:4], *bare[:4]], [*twin[:4], *twin[:4]],
            n * (16 + 52 + 12 + 4 + 4), bare=call)
        out["ring_start"]["bound"] = ring_start_bound(spec, n, 4)[:2]
        # the same lanes as the image loop makes them, int64
        wide = [t.to(torch.int64) for t in lanes]
        call, bare = start_bare(wide)
        again = ring_shade.ring_start(st, spec, *wide, 0)
        e = entry(lambda: ring_shade.ring_start(st, spec, *wide, 0),
                  lambda: ring_shade.start_reference(st, spec, *wide, 0),
                  [*again[:4], *bare[:4]], [*twin[:4], *twin[:4]],
                  n * (32 + 52 + 12 + 4 + 4), bare=call)
        e["bound"] = ring_start_bound(spec, n, 8)[:2]
        out["ring_start"]["int64"] = e
        out["ring_start"]["equal"] &= e["equal"]
        del twin, again, bare, wide, call
        ro, rd = state.rays()

        def scan():
            return ringlib.ring_closest_hit_local(ctx.shard, ctx.n_sph_pad,
                                                  ro, rd, ctx.mesh)

        t, obj, hit = scan()
        out["scan_ms"] = min(timed(scan) for _ in range(3))
        rows = ringlib.ring_gather_rows(ctx.mat_rows, obj, ctx.mesh)
        want = ringlib.ring_gather_rows_reference(ctx.mat_rows, obj,
                                                  ctx.mesh)
        # the bare launches: one step of the rows' ring over every lane,
        # each held to the plain selects too (one rank's shard holds every
        # row; at k > 1 the step with the rank's own shard)
        if obj.dtype != torch.int32:
            raise AssertionError("the ring's winners must be int32 ids")
        per = ctx.mat_rows.shape[0]
        first = mesh.rank * per
        shard = ctx.mat_rows.detach().contiguous()
        bare_rows = torch.zeros_like(want)
        step_want = ringlib._select_rows(shard, obj, mesh.rank, bare_rows)
        out["ring_rows"] = entry(
            lambda: ringlib.ring_gather_rows(ctx.mat_rows, obj, ctx.mesh),
            lambda: ringlib.ring_gather_rows_reference(ctx.mat_rows, obj,
                                                       ctx.mesh),
            [rows], [want], n * (4 + 96) + ctx.mat_rows.numel() * 4,
            bare=launch(lib.rt_ring_rows, shard.data_ptr(), first, per,
                        obj.data_ptr(), bare_rows.data_ptr(), n))
        out["ring_rows"]["equal"] &= torch.equal(bare_rows, step_want)
        del bare_rows, step_want
        if mesh.ranks == 1:
            ids = obj.to(torch.int64)
            lib_rows = torch.index_select(ctx.mat_rows, 0, ids)
            out["ring_rows"]["library_ms"] = best(
                lambda: torch.index_select(ctx.mat_rows, 0, ids),
                RING_REPS)[0]
            out["ring_rows"]["equal"] &= torch.equal(lib_rows, want)
            del lib_rows, ids
        del want
        blocked = None
        if n_light:
            q = ring_shade.ring_shadow(st, spec, state, t, hit, rows)
            q_twin = ring_shade.shadow_reference(st, spec, state, t, hit,
                                                 rows)
            out["ring_shadow"] = entry(
                lambda: ring_shade.ring_shadow(st, spec, state, t, hit, rows),
                lambda: ring_shade.shadow_reference(st, spec, state, t, hit,
                                                    rows),
                [q], [q_twin], n * (52 + 4 + 4 + 1 + 96 + 28 * n_light))
            ranged = [lt != LIGHT_DIRECTIONAL for lt in spec.light_type]
            blocked = torch.stack([ringlib.ring_occluded(
                ctx, V3(*q[li, :3]), V3(*q[li, 3:6]), q[li, 6], ranged[li])
                for li in range(n_light)])
            del q, q_twin
        saved = [x.clone() for x in state]

        def restore():
            for a, b in zip(state, saved):
                a.copy_(b)

        def run(step):
            step.finish(st, spec, state, t, hit, rows, blocked)
            return state

        restore()
        got = [x.clone() for x in run(ring_shade.ring_shade_kernels)]
        restore()
        twin = run(ring_shade.ring_shade_reference)
        pushed = int(got[3].sum()) if tree else 0
        per_lane = (2 * 52 + 2 * 12 + 4 + 1 + 96 + 4 + n_light
                    + (8 if tree else 0))
        # the state restored before each call, outside its time
        out["ring_finish"] = entry(
            lambda: run(ring_shade.ring_shade_kernels),
            lambda: run(ring_shade.ring_shade_reference),
            got[:4], twin[:4], n * per_lane + pushed * 52, before=restore)
        del saved, got, twin, state
    return out


def host_ms(fn, reps: int) -> float:
    """ms per call by the host clock, the device synchronised around the
    run (for work that waits on the host, as a staged hand-off does)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# the two-rank run (phase 20): what each rank renders
RANKS = 2
RING_FIELD = 4000               # the ring's field, and its rays:
RING_RAYS = 1 << 21             # the camera rays of 1024x1024 x 2 spp
RING_IMAGE = (256, 256, 2)      # the ring render: 1,006 objects, w, h, spp
# the ring render of the mixed 1,006-object field (the tree instance and
# the ranks' agreement on the rounds): w, h, spp
RING_MIXED_IMAGE = (128, 128, 2)
STEP_IMAGE = (64, 64, 2)        # the sharded step: cornell, w, h, spp
# the sharded step against loss_and_grad: float32 sums over 4,096 pixels,
# split over two ranks, in another order
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5


def ring_rays(sc, device):
    """(N, 3) origins and directions of the ring's camera rays."""
    from raytrace_tpu_torch.render.integrator import primary_rays

    lanes = pixel_lanes(1024, RING_RAYS // 2, 2, 1, device)
    o, d, _, _ = primary_rays(sc.data, sc.spec, *lanes, SEED)
    return torch.stack(list(o), 1), torch.stack(list(d), 1)


def step_inputs(device):
    """The sharded step's scene, pixels, samples and target."""
    from raytrace_tpu_torch.scene.builder import load_scene_file

    w, h, spp = STEP_IMAGE
    sc = load_scene_file(SCENE, device=device)
    spec = dataclasses.replace(sc.spec, width=w, height=h)
    pix = torch.arange(w * h, device=device)
    target = torch.full((w * h, 3), 0.25, device=device)
    return sc.data, spec, pix % w, pix // w, torch.arange(
        spp, device=device), target


# the ring's gradients (phases 19-20): the 65,536 camera rays of the
# 1,006-object linear field at 256x256, one sample a pixel
GRAD_IMAGE = 256
# the sharded renders with a checkpoint (phase 20): w, h, spp, and the
# lanes per rank, so that a render takes two launch groups of 2-sample
# chunks (32 chunks, then 16)
CK_IMAGE, CK_LANES = (64, 64, 96), 4096

# the bench's runs in phase 22 (raytrace_tpu_torch/bench.py; --large takes
# the sphere count, as bench.py's does: 1000 spheres are the 1,006-object
# field), and the range its default mode's launch may take, in multiples of
# phase 5's wrapper call (the sampler's lane ids and per-pixel mean added)
BENCH_RUNS = (("default", []), ("large linear", ["--large", "1000"]),
              ("large mixed", ["--large", "1000", "--mix"]),
              ("shard, one rank", ["--shard"]))
BENCH_RATIO = (0.9, 1.6)


def grad_inputs(device):
    """The 1,006-object linear field at ``GRAD_IMAGE`` square and its
    camera rays, (N, 3) origins and directions."""
    from raytrace_tpu_torch.render.integrator import primary_rays
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    sc = make_sphere_field(1000, mix_materials=False, width=GRAD_IMAGE,
                           height=GRAD_IMAGE, device=device)
    lanes = pixel_lanes(GRAD_IMAGE, GRAD_IMAGE ** 2, 1, 1, device)
    o, d, _, _ = primary_rays(sc.data, sc.spec, *lanes, SEED)
    return sc, torch.stack(list(o), 1), torch.stack(list(d), 1)


# the timed runs of each gradient path (phases 19-20), after its first
# run, which gives the gradients and warms it up
GRAD_REPS = 3


def place_weights(n: int, dtype, device="cpu") -> torch.Tensor:
    """The ring gradients' weight of each of ``n`` rays, by its place, so
    that a ray's cotangent names the ray."""
    return 1.0 + torch.arange(n, dtype=dtype, device=device) / n


def t_loss(t, hit):
    """The ring gradients' loss of a closest hit: the hit rays' t,
    weighted by place."""
    return (place_weights(t.shape[0], t.dtype, t.device)
            * torch.where(hit, t, 0.0)).sum()


def rec_loss(rec, w):
    """The ring gradients' loss of hit records: t, the normal and the
    winner's material values of the hit lanes, each lane weighted by
    ``w``."""
    parts = [rec.t, *rec.normal, *rec.diffuse, *rec.specular, *rec.ambient,
             rec.exponent, rec.ior, rec.msamples]
    return sum((w * torch.where(rec.hit, x, 0.0)).sum() for x in parts)


def grad_run(make_loss):
    """One forward and backward: ``make_loss() -> (loss, leaves)``.
    Returns the leaves' gradients and the forward's and the backward's ms
    by CUDA events, the device synchronised before (a ring's steps wait
    on host hand-offs, which the events' gap then holds)."""
    start, mid, end = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
    torch.cuda.synchronize()
    start.record()
    loss, leaves = make_loss()
    mid.record()
    loss.backward()
    end.record()
    torch.cuda.synchronize()
    return ([x.grad for x in leaves], start.elapsed_time(mid),
            mid.elapsed_time(end))


def best_grad_ms(make_loss) -> tuple[float, float]:
    """The best forward and the best backward ms of ``GRAD_REPS`` runs of
    :func:`grad_run`."""
    runs = [grad_run(make_loss)[1:] for _ in range(GRAD_REPS)]
    return min(f for f, _ in runs), min(b for _, b in runs)


def grad_losses(data, spec, ro, rd, mesh=None) -> dict:
    """The two gradient paths' ``make_loss``: ``t``, ``t_loss`` of the
    closest hits in prim_p, prim_q, ro and rd; ``records``, ``rec_loss``
    of the hit records in the per-object leaves (``ring.OBJECT_LEAVES``).
    Through the ring on ``mesh`` (``make_ring_intersector``; this rank's
    slice of the rays through ``ring_closest_hit`` under a ring context),
    every rank calling together; with no mesh through the dense closest
    hit (the plain scan of the whole table).  The gloo tests' ring and
    dense gradients take the same losses (``tests/test_torch_group.py``)."""
    from raytrace_tpu_torch.ops import intersect, vec
    from raytrace_tpu_torch.parallel import ring

    rays = slice(None)
    if mesh is not None:
        per = ro.shape[0] // mesh.ranks
        rays = slice(mesh.rank * per, (mesh.rank + 1) * per)

    def t():
        leaves = [x.clone().requires_grad_(True)
                  for x in (data.prim_p, data.prim_q, ro, rd)]
        wants = dataclasses.replace(data, prim_p=leaves[0], prim_q=leaves[1])
        if mesh is None:
            rec = intersect.closest_hit(wants, spec, vec.splat(leaves[2]),
                                        vec.splat(leaves[3]))
            return t_loss(rec.t, rec.hit), leaves
        t, _, hit = ring.make_ring_intersector(spec, mesh)(wants,
                                                           *leaves[2:])
        return t_loss(t, hit), leaves

    def records():
        leaves = [getattr(data, n).clone().requires_grad_(True)
                  for n in ring.OBJECT_LEAVES]
        wants = dataclasses.replace(data,
                                    **dict(zip(ring.OBJECT_LEAVES, leaves)))
        with (contextlib.nullcontext(wants) if mesh is None
              else ring.ring_context(wants, spec, mesh)) as used:
            rec = intersect.closest_hit(used, spec, vec.splat(ro[rays]),
                                        vec.splat(rd[rays]))
        w = place_weights(ro.shape[0], ro.dtype, ro.device)[rays]
        return rec_loss(rec, w), leaves

    return {"t": t, "records": records}


def path_grads(sc, ro, rd, mesh=None) -> dict:
    """Each of :func:`grad_losses`' paths run once for its gradients,
    ``_build``'s launch counts set to 0 just before those runs and read
    just after, then timed: ``{"grads": {path: gradients}, "launches":
    {...}, "ms": {path: (best forward, best backward)}}``."""
    from raytrace_tpu_torch.ops import _build

    losses = grad_losses(sc.data, sc.spec, ro, rd, mesh)
    for k in _build.LAUNCHES:
        _build.LAUNCHES[k] = 0
    grads = {p: grad_run(f)[0] for p, f in losses.items()}
    launches = dict(_build.LAUNCHES)
    return {"grads": grads, "launches": launches,
            "ms": {p: best_grad_ms(f) for p, f in losses.items()}}


def grad_excess(got: dict, want: dict):
    """``(excess, difference)``: the largest excess of ``got``'s gradients
    (``{path: gradients}``) over the float32 gradient rule against
    ``want``'s (``rtol 1e-5``, ``atol 1e-6`` plus 1e-6 of the leaf's
    largest gradient: ranks sum a leaf's gradient in another order), at
    most 0 where every entry holds and inf where one is not finite; and
    the largest absolute difference."""
    worst, diff = -math.inf, 0.0
    for g, w in ((g, w) for p in want for g, w in zip(got[p], want[p])):
        g, w = g.detach().cpu(), w.detach().cpu()
        if not torch.isfinite(g).all():
            return math.inf, math.inf
        tol = 1e-6 + 1e-6 * float(w.abs().max()) + 1e-5 * w.abs()
        worst = max(worst, float(((g - w).abs() - tol).max()))
        diff = max(diff, float((g - w).abs().max()))
    return worst, diff


class StopRender(Exception):
    """Raised from a render's progress, as a kill would stop it."""


def checkpoint_renders(out_dir: str, mesh) -> dict:
    """``render_image_sharded`` (cornell) and ``render_image_ring`` (the
    1,006-object linear field) at ``CK_IMAGE``, each with a checkpoint at a
    path of this rank's own: rendered without it, then stopped from its
    progress after the first launch group, resumed, and resumed with
    another seed, which must raise.  Per render: whether the resumed image
    equals the uncheckpointed one to the bit, the progress seen before the
    stop, the refusal, and whether this rank's file exists."""
    from raytrace_tpu_torch.parallel.ring import render_image_ring
    from raytrace_tpu_torch.parallel.tile import render_image_sharded
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    w, h, spp = CK_IMAGE
    cornell = load_scene_file(SCENE, device=mesh.device)
    cornell = dataclasses.replace(cornell, spec=dataclasses.replace(
        cornell.spec, width=w, height=h))
    field = make_sphere_field(1000, mix_materials=False, width=w, height=h,
                              device=mesh.device)
    out = {}
    for name, render, sc in (
            ("render_image_sharded, cornell", render_image_sharded, cornell),
            ("render_image_ring, the 1,006-object field", render_image_ring,
             field)):
        path = os.path.join(out_dir, f"ck_{render.__name__}_{mesh.rank}.npz")
        kw = dict(seed=SEED, spp=spp, mesh=mesh, max_lanes=CK_LANES)
        full = render(sc, **kw)
        seen = []

        def stop(frac):
            seen.append(frac)
            if len(seen) == 2:
                raise StopRender

        try:
            render(sc, progress=stop, checkpoint=path, **kw)
        except StopRender:
            pass
        resumed = render(sc, checkpoint=path, **kw)
        try:
            render(sc, checkpoint=path, **dict(kw, seed=SEED + 1))
            refused = None
        except ValueError as e:
            refused = str(e)
        out[name] = {"equal": bool(np.array_equal(resumed, full)),
                     "seen": seen, "refused": refused,
                     "file": os.path.exists(path),
                     "mean": float(full.mean())}
    return out


def rank_worker(out_dir: str) -> int:
    """One rank of the two-rank run on the one card, joined through the
    environment protocol that chip_smoke.py sets: the multi-process CLI,
    the ring at k = 2 (intersection and a render), the sharded step, the
    ring's hand-off timed, the ring's gradients, and the sharded renders
    with a checkpoint; its results saved for the parent."""
    import torch.distributed as dist

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.entry import dryrun_multichip
    from raytrace_tpu_torch.ops import _build
    from raytrace_tpu_torch.ops import intersect
    from raytrace_tpu_torch.ops.vec import V3
    from raytrace_tpu_torch.optim import make_sharded_step
    from raytrace_tpu_torch.parallel import mesh as meshlib
    from raytrace_tpu_torch.parallel import ring
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    if not meshlib.maybe_init_distributed("cuda"):
        raise RuntimeError("the rank's environment names no process group")
    mesh = meshlib.make_mesh()
    device, r = mesh.device, mesh.rank
    res = {"rank": r, "ranks": mesh.ranks, "backend": dist.get_backend(),
           "device": str(device)}
    res["cli_rc"] = cli.main([SCENE, "-o", os.path.join(out_dir, "multi.bmp"),
                              "--spp", "16", "-q", "--log-json",
                              os.path.join(out_dir, f"log{r}.jsonl")])
    sc = make_sphere_field(RING_FIELD, mix_materials=False, device=device)
    ro, rd = ring_rays(sc, device)
    t0 = time.perf_counter()
    res["t"], res["obj"], res["hit"] = (
        x.cpu() for x in ring.make_ring_intersector(sc.spec, mesh)(
            sc.data, ro, rd))
    res["intersect_s"] = time.perf_counter() - t0
    tables, ids, n_sph = ring.shard_geometry(sc.data, sc.spec, mesh.ranks)
    shard = ring.make_shard(tables[r].clone(), ids[r].clone(), n_sph)
    res["shard_bytes"] = sum(x.numel() * x.element_size() for x in shard)
    res["handoff_ms"] = host_ms(lambda: meshlib.ring_shift(shard, mesh), 10)
    # the rows' ring at k = 2 (ring_rows on each resident row shard)
    # against its plain selects, on this rank's half of the rays
    with ring.ring_context(sc.data, sc.spec, mesh):
        ctx = intersect.ring_ctx()
        half = ro.shape[0] // mesh.ranks
        o, d = (V3(*x[r * half:(r + 1) * half].unbind(1)) for x in (ro, rd))
        _, obj, _ = ring.ring_closest_hit_local(ctx.shard, ctx.n_sph_pad, o,
                                                d, mesh)
        got = ring.ring_gather_rows(ctx.mat_rows, obj, mesh)
        want = ring.ring_gather_rows_reference(ctx.mat_rows, obj, mesh)
        res["rows_equal"] = torch.equal(got, want)
        res["rows_from_the_other_shard"] = float(
            (obj // ctx.mat_rows.shape[0] != r).float().mean())
        del got, want
    w, h, spp = RING_IMAGE
    field = make_sphere_field(1000, mix_materials=False, width=w, height=h,
                              device=device)
    t0 = time.perf_counter()
    res["ring_image"] = torch.from_numpy(ring.render_image_ring(
        field, seed=SEED, spp=spp, mesh=mesh))
    res["ring_render_s"] = time.perf_counter() - t0
    # the mixed field through the tree instance: the ranks' lanes end at
    # different rounds, and both must take the same ring steps
    w, h, spp = RING_MIXED_IMAGE
    field = make_sphere_field(1000, mix_materials=True, width=w, height=h,
                              device=device)
    t0 = time.perf_counter()
    res["ring_mixed_image"] = torch.from_numpy(ring.render_image_ring(
        field, seed=SEED, spp=spp, mesh=mesh))
    res["ring_mixed_render_s"] = time.perf_counter() - t0
    data, spec, px, py, sids, target = step_inputs(device)
    loss, grads = make_sharded_step(spec, mesh, SEED)(data, px, py, sids,
                                                      target)
    res["loss"] = loss.cpu()
    res["grads"] = {f.name: getattr(grads, f.name).cpu()
                    for f in dataclasses.fields(grads)}
    res["launches"] = dict(_build.LAUNCHES)
    # the ring's gradients at k = 2 (K5 and ring_rows carry the forwards)
    gsc, gro, grd = grad_inputs(device)
    g = path_grads(gsc, gro, grd, mesh)
    g["grads"] = {p: [x.cpu() for x in gs] for p, gs in g["grads"].items()}
    res["grads_ring"] = g
    del g, gsc, gro, grd
    res["checkpoint"] = checkpoint_renders(out_dir, mesh)
    dry = dryrun_multichip(RANKS)
    res["dryrun"] = dict(dry, image=torch.from_numpy(dry["image"]))
    dist.destroy_process_group()
    torch.save(res, os.path.join(out_dir, f"rank{r}.pt"))
    print(json.dumps({k: v for k, v in res.items()
                      if isinstance(v, (int, float, str, dict))
                      and k not in ("grads", "grads_ring", "dryrun")}))
    return 0


def run_ranks(out_dir: str, timeout: float = 420.0) -> list:
    """Start the ranks as processes of this script, under the environment
    protocol, and wait for them; each must exit 0 in time.  Returns their
    saved results."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAYTRACE_TPU_")}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank-worker", out_dir],
        env=dict(env, RAYTRACE_TPU_COORDINATOR=f"localhost:{port}",
                 RAYTRACE_TPU_NUM_PROCESSES=str(RANKS),
                 RAYTRACE_TPU_PROCESS_ID=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        print(f"    rank {r} (exit {p.returncode}): {out.strip()[-3000:]}")
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(RANKS)]


def main() -> int:
    # a line at a time, so that a run cut at its time limit shows where
    sys.stdout.reconfigure(line_buffering=True)
    # ---- phase 1: device ----
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs an NVIDIA GPU")
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(f"[1] device: {smi}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    from raytrace_tpu_torch.utils import gpu_info
    props = torch.cuda.get_device_properties(0)
    peaks = gpu_info.peaks(props)  # raises for a card it does not know
    if peaks is not H100_SXM:
        raise AssertionError(f"the bounds are the {H100_SXM.name}'s")
    print(f"    as the runtime reports it: {gpu_info.card(props)}; its "
          f"published peaks (the bounds' figures): {peaks.source}")

    from raytrace_tpu_torch import cli, optim
    from raytrace_tpu_torch.models import backgrounds
    from raytrace_tpu_torch.ops import _build, intersect_scan
    from raytrace_tpu_torch.ops.intersect import closest_hit, scene_tables
    from raytrace_tpu_torch.ops.vec import V3
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.render.integrator import (primary_rays,
                                                      sample_pixels,
                                                      tree_loop_stack)
    from raytrace_tpu_torch.render.work import path_work as count_work
    from raytrace_tpu_torch.render.work import warp_sample
    from raytrace_tpu_torch.scene import dsl
    from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file
    from raytrace_tpu_torch.scene.procedural import (make_sphere_field,
                                                     sphere_field_source)
    from raytrace_tpu_torch.scene.schema import SceneData

    def path_work(data, spec, lanes, seed):
        """What a launch's paths need, counted on 512 of its warps."""
        return count_work(data, spec, [warp_sample(t) for t in lanes], seed)

    def by_depth(work):
        return ", ".join(f"{d}: {a:.3f} x {b:.2f}, a warp's union {c:.2f}"
                         for d, (a, b, c) in work["by_depth"].items())

    t_start = time.perf_counter()

    def at():
        """Seconds since the start, for the phase headers."""
        return f"{time.perf_counter() - t_start:.0f} s"

    k_lin, k_tree = megakernel.KERNEL_LINEAR, megakernel.KERNEL_TREE
    k_scan, k_sky = megakernel.KERNEL_SCAN, megakernel.KERNEL_SKY
    k_ring = megakernel.KERNEL_RING
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
          f"{' '.join(_build.NVCC_FLAGS)} (and, per kernel, "
          f"{_build.KERNEL_FLAGS}) in {time.perf_counter() - t0:.2f} s")
    for k in megakernel.KERNELS:
        for line in _build.build_logs.get(k, "").splitlines():
            inst = re.search(r"(megakernel_[a-z]+|scan_hit_kernel|"
                             r"skybox_kernel|ring_[a-z]+_kernel)"
                             r"(?:I((?:L[bi]\d+E)+)E|E)", line)
            if "entry function" in line and inst:
                args = re.findall(r"\d+", inst.group(2) or "")
                print(f"    {inst.group(1)}<{', '.join(args)}>:")
            elif "registers" in line or "stack frame" in line:
                print(f"      {line.strip()}")
    # the fold's staging limit, derived from the card and the scan
    # kernel's registers, and what it stages
    scan_attrs = [(ctypes.c_int * 4)() for _ in (0, 1)]
    for staged_form, attrs in enumerate(scan_attrs):
        if intersect_scan._lib().rt_scan_hit_attrs(staged_form, attrs) != 0:
            raise AssertionError("cudaFuncGetAttributes failed")
    fold_limit = intersect_scan.fold_shared_max_bytes()
    staged = {}
    for n_sph in (1000, 4000):
        fsc = make_sphere_field(n_sph, mix_materials=False, device=device)
        chunks = scene_tables(fsc.data, fsc.spec).table.shape[0] // 32
        other = megakernel.scene_shared_bytes(fsc.spec)
        staged[n_sph + 6] = (intersect_scan.fold_bytes(chunks) + other,
                             intersect_scan.fold_in_shared(chunks, other))
    card_info = gpu_info.card(props)
    print(f"    the fold's staging limit: {fold_limit} B, from "
          f"{card_info.shared_per_sm} B of shared memory an SM and the scan "
          f"kernel's {scan_attrs[0][0]} registers with its table in device "
          f"memory ({gpu_info.resident_blocks(card_info, scan_attrs[0][0], 256)} "
          f"blocks of 256 threads an SM; {scan_attrs[1][0]} registers and "
          f"{gpu_info.resident_blocks(card_info, scan_attrs[1][0], 256)} blocks "
          f"with it staged); (bytes, staged) per field: {staged}")
    if not (staged[1006][1] and not staged[4006][1]):
        raise AssertionError("the derived limit stages other fields")
    # the skybox faces packed for the lookup, at the test cube's shape: what
    # they take on the card and what one packing costs
    cube = torch.rand((6, 1024, 1024, 3), generator=torch.Generator(
        device=device).manual_seed(SEED), device=device)
    pack_ms = [once_ms(lambda: backgrounds.pack_sky(cube, FACE_SIZES))[0]
               for _ in range(3)]
    packed = backgrounds.pack_sky(cube, FACE_SIZES)
    print(f"    the packed skybox faces of a {tuple(cube.shape)} cube (faces "
          f"{FACE_SIZES}): {packed.numel() * 4} B beside the cube's "
          f"{cube.numel() * 4} B; packing {[round(x, 4) for x in pack_ms]} ms "
          f"per cube; on {smi}")
    del cube, packed
    k_lin_large, k_tree_large = k_lin + " (large)", k_tree + " (large)"
    k_lin_sky, k_tree_sky = k_lin + " (sky)", k_tree + " (sky)"
    # the lines of the closing "kernels" object: the four kernels, and
    # apart the render kernels' large instances (the in-kernel table fold)
    # and their skybox instances (the lookup where a ray misses)
    # and the tree kernel's deep stacks: in local memory at 128 and 256
    # entries, and in the slab above that
    k_tree_128, k_tree_256 = k_tree + " (stack 128)", k_tree + " (stack 256)"
    k_tree_slab = k_tree + " (slab)"
    # and the kernels of ring_shade.cu, what an object-sharded render runs
    # on the card between the scan kernel's launches: the primary rays,
    # the rows' ring, the shadow rays, and the ring instances of K1 and K3
    k_ring_start = k_ring + " (ring_start)"
    k_ring_rows = k_ring + " (ring_rows)"
    k_ring_shadow = k_ring + " (ring_shadow)"
    k_ring_lin = k_ring + " (ring_finish, linear)"
    k_ring_tree = k_ring + " (ring_finish, tree)"
    rows = (k_lin, k_tree, k_lin_large, k_tree_large, k_scan, k_sky,
            k_lin_sky, k_tree_sky, k_tree_128, k_tree_256, k_tree_slab,
            k_ring_start, k_ring_rows, k_ring_shadow, k_ring_lin, k_ring_tree)
    max_err = {k: 0.0 for k in rows}

    # ---- phase 3: the linear kernel vs plain version on the card ----
    scene = load_scene_file(SCENE, device=device)
    data, spec = scene.data, scene.spec
    rand_lanes = random_lanes(spec, 65536, SEED, device)
    main_launch, s_main = cli_launch_lanes(spec, device)
    print(f"[3, {at()}] " "kernel vs plain on cornell_indirect, then on a "
          "scene of exact ties:")
    for name, lanes in (("random cornell lanes", rand_lanes),
                        (f"the CLI's launch, {spec.width}x{spec.height} x "
                         f"{s_main} spp", (main_launch,))):
        stats = check_kernel(megakernel, k_lin, data, spec, lanes, SEED, name)
        max_err[k_lin] = max(max_err[k_lin], stats["max_abs_err"])

    # exact ties: the winner's object id, which the radiance names at
    # max_depth -1, equal on every lane
    ties = build_scene(dsl.parse(TIES), device=device)
    ties_spec = dataclasses.replace(ties.spec, max_depth=-1)
    for name, lanes in (("random lanes", random_lanes(ties_spec, 65536, SEED,
                                                       device)),
                        ("every pixel x 2 aa", pixel_lanes(
                            32, 32 * 32, 2, 1, device))):
        before = megakernel.LAUNCHES[k_lin]
        got = ambient_ids(megakernel.radiance_lanes(
            ties.data, ties_spec, *lanes, SEED).x)
        want = ambient_ids(megakernel.radiance_lanes_reference(
            ties.data, ties_spec, *lanes, SEED).x)
        torch.cuda.synchronize()
        if megakernel.LAUNCHES[k_lin] != before + 1:
            raise AssertionError("the tie scene did not launch the kernel")
        counts = torch.bincount(want + 1, minlength=8).tolist()
        print(f"    tie scene (coincident planes), {name}: winners by object "
              f"id (misses first) {counts}; equal on "
              f"{float((got == want).float().mean()):.6f} of "
              f"{got.shape[0]} lanes")
        if not torch.equal(got, want):
            raise AssertionError("K1's winners differ on the tie scene")

    # ---- phase 4: the main path, the CLI on the card ----
    done, wall, launches, size = cli_render(cli, megakernel, k_lin, SCENE,
                                            ["--spp", "16"], spec)
    lin_launches = launches[k_lin]
    print(f"[4, {at()}] "
          f"CLI render {spec.width}x{spec.height} x 16 spp: {wall:.2f} s "
          f"wall, {done['seconds']} s render ("
          f"{done['seconds_profiled']} s under the profiler, the device busy "
          f"{done['device_busy']:.3f} of that), launches {launches}, mean "
          f"radiance {done['mean_radiance']:.6f}, BMP {size} B")
    # the same render with --profile: its trace names K1's kernel (the
    # device's record and the wrapper's range); then a one-rank sharded
    # step, whose backward runs the plain path, recorded the same way,
    # names the five phases
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = os.path.join(tmp, "trace")
        t0 = time.perf_counter()
        rc = cli.main([SCENE, "-o", os.path.join(tmp, "p.bmp"), "--spp", "16",
                       "--device", "cuda", "--profile", trace_dir, "-q"])
        prof_wall = time.perf_counter() - t0
        path = os.path.join(trace_dir, "trace.json")
        if rc != 0 or not os.path.exists(path):
            raise AssertionError(f"the CLI with --profile exited {rc}")
        names = trace_names(path)
        kernels = [n for n in names.get("kernel", ()) if k_lin in n]
        print(f"    --profile: {prof_wall:.2f} s wall, a {os.path.getsize(path)} "
              f"B trace; its device kernels named {k_lin}: {kernels}; its "
              f"ranges: {sorted(names.get('user_annotation', ()))}")
        if not kernels or k_lin not in names.get("user_annotation", ()):
            raise AssertionError("the trace does not name K1")
        from torch.profiler import profile as torch_profile

        from raytrace_tpu_torch.parallel.mesh import Mesh
        from raytrace_tpu_torch.utils.profiling import trace_activities
        step_data, step_spec, px, py, sids, target = step_inputs(device)
        step = optim.make_sharded_step(step_spec, Mesh(device), SEED)
        with torch_profile(activities=trace_activities(device)) as prof:
            step(step_data, px, py, sids, target)
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(tmp, "step.json"))
        ranges = trace_names(os.path.join(tmp, "step.json")).get(
            "user_annotation", set())
        want_ranges = {"raygen", "intersect", "shade", "background",
                       "grad_psum", k_lin}
        print(f"    a one-rank sharded step under the profiler: ranges "
              f"{sorted(ranges)}")
        if not want_ranges <= ranges:
            raise AssertionError(f"the step's trace lacks "
                                 f"{sorted(want_ranges - ranges)}")

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

    print(f"[5, {at()}] {n} lanes of cornell at 1024x1024:")
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
    library_ms = {}
    # the ring's kernels timed as bare launches too (ring_round)
    bare_ms = {}
    work = path_work(data, spec_b, lanes, 0)
    old_ms, old_by = render_bound(spec_b, n, work)
    print(f"    needs {work['visits']:.3f} live nodes per lane; the object "
          f"tests alone bound it at {old_ms:.4f} ms ({old_by})")
    lin_log = _build.build_logs.get(k_lin, "")
    lin_sass = cuobjdump_sass(_build.library_path(k_lin))
    bounds = {k_lin: k1_report("cornell", "lean", spec_b, n, work, ms,
                               lin_sass, lin_log, smi)}

    # ---- phase 6: the linear kernel with lights, mirror and DoF ----
    lit = build_scene(dsl.parse(LIT_MIRROR), device=device)
    print(f"[6, {at()}] " "kernel vs plain on the lit mirror scene (point and "
          "directional lights, Phong mirror, depth of field):")
    lit_launch, s_lit = cli_launch_lanes(lit.spec, device)
    for name, lanes in (("65,536 random lanes",
                         random_lanes(lit.spec, 65536, SEED, device)),
                        (f"the CLI's launch, {lit.spec.width}x"
                         f"{lit.spec.height} x {s_lit} aa x "
                         f"{lit.spec.cam_samples} lens", (lit_launch,))):
        stats = check_kernel(megakernel, k_lin, lit.data, lit.spec, lanes,
                             SEED, name)
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
    print(f"[7, {at()}] " "tree kernel vs plain:")
    for label, sc, n in (("materials_showcase, 65,536 random lanes", show,
                          65536),
                         ("4-sample IndirectPhong, 16,384 random lanes",
                          ind4, 16384), *deep):
        m, levels, nodes, cap = tree_loop_stack(sc.spec)
        print(f"    {label}: m={m}, {levels} levels, {nodes} nodes, "
              f"stack {cap}")
        t0 = time.perf_counter()
        lanes = random_lanes(sc.spec, n, SEED, device)
        want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes,
                                                   SEED)
        stats = check_kernel(
            megakernel, k_tree, sc.data, sc.spec, lanes, SEED,
            f"{label}, stack instance {megakernel.tree_instance(cap)}", want)
        max_err[k_tree] = max(max_err[k_tree], stats["max_abs_err"])
        print(f"    ({time.perf_counter() - t0:.2f} s)")

    # ---- phase 8: the showcase through the CLI at its own settings ----
    s = show.spec
    show_launch, s_launch = cli_launch_lanes(s, device)
    show_launch_lanes = [t.to(torch.int32) for t in show_launch.expand()]
    print(f"[8, {at()}] "
          f"the CLI's launch, {s.width}x{s.height} x {s_launch} aa x "
          f"{s.cam_samples} lens samples:")
    t0 = time.perf_counter()
    stats = check_kernel(megakernel, k_tree, show.data, s, (show_launch,),
                         SEED, "the CLI's launch")
    print(f"    ({time.perf_counter() - t0:.2f} s)")
    max_err[k_tree] = max(max_err[k_tree], stats["max_abs_err"])
    # the slab decodes a factored launch too: every 8th pixel of it
    slab_launch, _ = cli_launch_lanes(s, device, every=8)
    with forced_slab(megakernel):
        stats = check_kernel(megakernel, k_tree, show.data, s,
                             (slab_launch,), SEED,
                             "the CLI's launch, every 8th pixel, the slab form")
    max_err[k_tree_slab] = max(max_err[k_tree_slab], stats["max_abs_err"])
    done, wall, launches, size = cli_render(cli, megakernel, k_tree, SHOWCASE,
                                            [], s)
    tree_launches = launches[k_tree]
    print(f"    CLI render of materials_showcase {s.width}x{s.height} x "
          f"{s.antialias} aa x {s.cam_samples} lens samples: {wall:.2f} s "
          f"wall, {done['seconds']} s render ("
          f"{done['seconds_profiled']} s under the profiler, the device busy "
          f"{done['device_busy']:.3f} of that), launches {launches}, mean "
          f"radiance {done['mean_radiance']:.6f}, BMP {size} B, on {smi}")

    # ---- phase 9: the lit kernels at 2,097,152 lanes per launch ----
    print(f"[9, {at()}] " "2,097,152 lanes per launch:")
    for kname, label, sc, k_reps, p_reps in (
            (k_tree, "tree kernel, materials_showcase", show, 10, 1),
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
        print(f"    {label}: kernel {ms:.4f} ms/call (runs "
              f"{[round(x, 4) for x in times['kernel']]}), {k_dev:.4f} ms on "
              f"the device; plain {plain_ms:.4f} ms/call (runs "
              f"{[round(x, 4) for x in times['plain']]}); on {smi}")
        if kname == k_lin:
            k1_report("lit mirror scene", "lit", sc.spec, 1 << 21,
                      path_work(sc.data, sc.spec, lanes, 0), ms, lin_sass,
                      lin_log, smi)
        if kname == k_tree:
            timing[k_tree] = (ms, plain_ms)
            work = path_work(sc.data, sc.spec, lanes, 0)
            bounds[k_tree] = render_bound(sc.spec, 1 << 21, work)
            print(f"    needs {work['visits']:.3f} live nodes per lane, "
                  f"{work['warp_visits']:.3f} the largest of a warp's 32 (the "
                  f"rounds the warp takes); bound {bounds[k_tree][0]:.4f} ms "
                  f"({bounds[k_tree][1]})")
            n_cli = show_launch_lanes[0].shape[0]

            def kernel_cli():
                megakernel.radiance_lanes(sc.data, sc.spec, show_launch, 0)

            cli_ms = [ms_per_launch(kernel_cli, 3, k_reps) for _ in range(2)]
            work = path_work(sc.data, sc.spec, show_launch_lanes, 0)
            cli_bound = render_bound(sc.spec, n_cli, work)
            print(f"    on the CLI's own launch, {n_cli} pixel-ordered lanes ("
                  f"{work['visits']:.3f} live nodes per lane, "
                  f"{work['warp_visits']:.3f} the largest of a warp): runs "
                  f"{[round(x, 4) for x in cli_ms]} ms/call; bound "
                  f"{cli_bound[0]:.4f} ms ({cli_bound[1]}); on {smi}")

    # ---- phase 10: the scan kernel vs its plain version ----
    n_chk = 65536
    fields = {}
    for n_sph in (1000, 4000):
        sc = make_sphere_field(n_sph, mix_materials=False, device=device)
        fields[n_sph] = (sc, scene_tables(sc.data, sc.spec))
    rs = np.random.RandomState(SEED)
    rand_o = V3(*(torch.from_numpy(rs.uniform(-28, 28, n_chk).astype(
        np.float32)).to(device) for _ in range(3)))
    rand_d = V3(*(torch.from_numpy(rs.normal(0, 1, n_chk).astype(
        np.float32)).to(device) for _ in range(3)))
    print(f"[10, {at()}] "
          "scan kernel vs plain, 65,536 rays (id and hit mismatch "
          "shares, largest relative t error on agreeing hits; mean sphere "
          "chunks a ray enters):")
    for n_sph, (sc, tb) in fields.items():
        cam_o, cam_d, _, _ = primary_rays(
            sc.data, sc.spec, *random_lanes(sc.spec, n_chk, SEED, device),
            SEED)
        for label, (o, d) in (("camera rays", (cam_o, cam_d)),
                              ("random rays", (rand_o, rand_d))):
            before = megakernel.LAUNCHES[k_scan]
            t, gid, hit = intersect_scan.scan_hit(tb.table, tb.ids,
                                                  tb.n_sph_pad, o, d)
            torch.cuda.synchronize()
            if megakernel.LAUNCHES[k_scan] != before + 1:
                raise AssertionError("scan_hit did not launch its kernel once")
            want = intersect_scan.scan_hit_reference(
                tb.table, tb.ids, tb.n_sph_pad, o, d, tb.bounds,
                return_entered=True, return_mask=True)
            union = want[4].reshape(-1, 32, tb.n_sph_pad // 32).any(dim=1)
            staged = intersect_scan.fold_in_shared(tb.table.shape[0] // 32)
            print(f"    {n_sph + 6} objects (the table "
                  f"{'staged in shared' if staged else 'read from device'} "
                  f"memory), {label}, entering "
                  f"{float(want[3].float().mean()):.2f} of "
                  f"{tb.n_sph_pad // 32} sphere chunks, the 32 rays of a warp "
                  f"together {float(union.sum(dim=1).float().mean()):.2f}:")
            stats = compare_scan((t, gid, hit), want)
            max_err[k_scan] = max(max_err[k_scan], stats["max_abs_err"])

    # ---- phase 11: the large instances vs the plain path ----
    lin, lin_tb = fields[1000]
    field4k = fields[4000][0]   # the ring's field (phases 19-20)
    mixed = make_sphere_field(1000, mix_materials=True, device=device)
    lit_large = build_scene(dsl.parse(sphere_field_source(
        1000, mix_materials=False).replace("lights: [ ]", """lights: [
        { model: PointLight { location: (0, 20, 10) }
          color: rgb(30, 28, 26) } ]""")), device=device)
    print(f"[11, {at()}] "
          "large scenes (1,006 objects; 4,006, whose table the kernels "
          "read from device memory), 65,536 random lanes:")
    for kname, row, label, sc in (
            (k_lin, k_lin_large, "linear field", lin),
            (k_tree, k_tree_large, "mixed field (m = 2, 63 nodes)", mixed),
            (k_lin, k_lin_large, "linear field with a point light",
             lit_large),
            (k_lin, k_lin_large, "linear field, 4,006 objects",
             fields[4000][0])):
        if not megakernel.is_large(sc.spec):
            raise AssertionError(f"{label}: not a large scene")
        t0 = time.perf_counter()
        lanes = random_lanes(sc.spec, n_chk, SEED, device)
        want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes,
                                                   SEED)
        n_chunks = scene_tables(sc.data, sc.spec).table.shape[0] // 32
        staged = intersect_scan.fold_in_shared(
            n_chunks, megakernel.scene_shared_bytes(sc.spec))
        stats = check_kernel(
            megakernel, kname, sc.data, sc.spec, lanes, SEED,
            f"{label} (its table of {intersect_scan.fold_bytes(n_chunks)} B "
            f"{'staged in shared' if staged else 'read from device'} memory)",
            want)
        max_err[row] = max(max_err[row], stats["max_abs_err"])
        if stats["share_outside"] > 0:
            raise AssertionError(f"{label}: a lane outside the rule")
        print(f"    no lane outside the rule "
              f"({time.perf_counter() - t0:.2f} s)")
    for label, sc in (("linear field", lin), ("mixed field", mixed)):
        lanes = random_lanes(sc.spec, n_chk, SEED, device)
        before = dict(megakernel.LAUNCHES)
        split = megakernel.radiance_lanes_split(sc.data, sc.spec, *lanes,
                                                SEED)
        torch.cuda.synchronize()
        rose = {k: megakernel.LAUNCHES[k] - before[k]
                for k in megakernel.KERNELS}
        # a round a node: one scan launch, the rows' gather and
        # ring_finish, and a ring_start (a linear scene takes max_depth + 2
        # rounds)
        rounds = rose[k_scan]
        if (rose != {k_lin: 0, k_tree: 0, k_scan: rounds, k_sky: 0,
                     k_ring: 2 * rounds + 1}
                or (sc is lin and rounds != lin.spec.max_depth + 2)):
            raise AssertionError(f"split path launches: {rose}")
        print(f"    split path (the ring instances, {rounds} rounds: "
              f"{rose[k_scan]} scan kernel and {rose[k_ring]} ring kernel "
              f"launches) vs the fused kernel, {label}:")
        compare(split, megakernel.radiance_lanes(sc.data, sc.spec, *lanes,
                                                 SEED))

    # ---- phase 12: large scenes through the CLI at their own settings ----
    print(f"[12, {at()}] "
          "the CLI on the 1,006-object fields, 1024x1024 x 4 spp:")
    large_launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for kname, row, label, mix in ((k_lin, k_lin_large, "linear", False),
                                       (k_tree, k_tree_large, "mixed", True)):
            path = os.path.join(tmp, f"field_{label}.txt")
            with open(path, "w") as f:
                f.write(sphere_field_source(1000, mix_materials=mix))
            sc = load_scene_file(path, device=device)
            if len(sc.spec.live_objects()) != 1006:
                raise AssertionError("the field file lost objects")
            # the plain DFS takes 37 s on the whole launch
            launch, s_launch = cli_launch_lanes(sc.spec, device,
                                                every=8 if mix else 1)
            t0 = time.perf_counter()
            stats = check_kernel(
                megakernel, kname, sc.data, sc.spec, (launch,), SEED,
                f"{label} field, the CLI's launch, {sc.spec.width}x"
                f"{sc.spec.height} x {s_launch} aa"
                + (", every 8th pixel" if mix else ""))
            print(f"    ({time.perf_counter() - t0:.2f} s)")
            max_err[row] = max(max_err[row], stats["max_abs_err"])
            done, wall, launches, size = cli_render(cli, megakernel, kname,
                                                    path, [], sc.spec)
            large_launches[row] = launches[kname]
            print(f"    {label} field: {wall:.2f} s wall, {done['seconds']} s "
                  f"render ({done['seconds_profiled']} s under the profiler, "
                  f"the device busy {done['device_busy']:.3f} of that), "
                  f"launches {launches}, mean radiance "
                  f"{done['mean_radiance']:.6f}, BMP {size} B, on {smi}")

    # ---- phase 13: large scenes at 2,097,152 lanes per launch ----
    print(f"[13, {at()}] "
          "large scenes, 2,097,152 lanes per launch (pixel-ordered, "
          "1024x1024 x 2 spp):")
    n = 1 << 21
    lanes = [t.to(torch.int32) for t in pixel_lanes(1024, n // 2, 2, 1,
                                                    device)]

    for row, label, sc, plain_once in (
            (k_lin_large, "linear kernel, 1,006 objects", lin, True),
            (None, "linear kernel, 4,006 objects", fields[4000][0], False),
            (k_tree_large, "tree kernel, 1,006 objects, mixed", mixed, True)):
        def kernel():
            return megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 0)

        tb = scene_tables(sc.data, sc.spec)
        got = kernel()
        ms = min(ms_per_launch(kernel, 2, 5) for _ in range(2))
        k_dev = device_ms(kernel, 5, megakernel.kernel_for(sc.spec))
        work = path_work(sc.data, sc.spec, lanes, 0)
        b_ms, b_by = render_bound(sc.spec, n, work, tb)
        line = (f"    {label}: kernel {ms:.4f} ms/call, {k_dev:.4f} ms on the "
                f"device; needs {work['visits']:.3f} live nodes per lane ("
                f"{work['warp_visits']:.3f} the largest of a warp), "
                f"each entering {work['chunks'] / work['visits']:.2f} of "
                f"{tb.n_sph_pad // 32} sphere chunks; bound {b_ms:.4f} ms "
                f"({b_by}); per depth, live lanes per lane x chunks a ray "
                f"enters, and the union over a warp's live lanes: "
                f"{by_depth(work)}")
        if plain_once:
            # the plain path takes seconds here: one run, not warmed up
            plain_ms, want = once_ms(
                lambda: megakernel.radiance_lanes_reference(
                    sc.data, sc.spec, *lanes, 0))
            line += f"; plain {plain_ms:.1f} ms (one run)"
        print(f"{line}; on {smi}")
        if row is not None:
            print("    that launch vs the plain run:")
            stats = compare(got, want, exact=row == k_tree_large)
            max_err[row] = max(max_err[row], stats["max_abs_err"])
            timing[row] = (ms, plain_ms)
            bounds[row] = (b_ms, b_by)
        if sc is lin:
            fused = got
        elif sc is mixed:
            fused_mixed = got

    # the split path: the ring instances on a one-shard ring, each round's
    # scan kernel launch and ring kernels between them
    for label, sc, fused_out in (("linear", lin, fused),
                                 ("mixed", mixed, fused_mixed)):
        def split_path():
            return megakernel.radiance_lanes_split(sc.data, sc.spec, *lanes,
                                                   0)

        for k in megakernel.LAUNCHES:
            megakernel.LAUNCHES[k] = 0
        split = split_path()
        split_launches = megakernel.LAUNCHES[k_scan]
        ring_n = megakernel.LAUNCHES[k_ring]
        if (split_launches < 1 or ring_n != 2 * split_launches + 1
                or megakernel.LAUNCHES[k_lin] or megakernel.LAUNCHES[k_tree]):
            raise AssertionError(f"the split path's launches "
                                 f"{dict(megakernel.LAUNCHES)}")
        split_ms = min(ms_per_launch(split_path, 1, 3) for _ in range(2))
        scan_dev = device_ms(split_path, 2, "scan_hit", split_launches)
        ring_dev = device_ms(split_path, 2, "ring_", ring_n)
        print(f"    split path, 1,006 objects, {label} field: {split_ms:.4f} "
              f"ms/call, of which "
              f"{scan_dev:.4f} ms in its {split_launches} scan kernel "
              f"launches and {ring_dev:.4f} ms in its {ring_n} ring kernel "
              f"launches (device time); on {smi}; vs the fused kernel on "
              f"the same lanes:")
        compare(split, fused_out)
    del fused_mixed
    for n_sph, (sc, tb) in fields.items():
        o, d, _, _ = primary_rays(sc.data, sc.spec, *lanes, 0)

        def scan():
            return intersect_scan.scan_hit(tb.table, tb.ids, tb.n_sph_pad, o,
                                           d, tb.bounds)

        def scan_plain():
            return intersect_scan.scan_hit_reference(tb.table, tb.ids,
                                                     tb.n_sph_pad, o, d)

        ms = min(ms_per_launch(scan, 2, 10) for _ in range(2))
        dev = device_ms(scan, 10, "scan_hit")
        plain_ms, want = once_ms(scan_plain)
        n_sph_chunks = tb.n_sph_pad // 32
        counted = intersect_scan.scan_hit_reference(
            tb.table, tb.ids, tb.n_sph_pad,
            V3(*(warp_sample(c, n_chk // 32) for c in o)),
            V3(*(warp_sample(c, n_chk // 32) for c in d)), tb.bounds,
            return_entered=True, return_mask=True)
        entered = counted[3].float().mean().item()
        union = counted[4].reshape(-1, 32, n_sph_chunks).any(dim=1).sum(
            dim=1).float().mean().item()
        b_ms, b_by = bound(*scan_counts(n, entered, n_sph_chunks, 5,
                                        tb.table.shape[0]))
        print(f"    scan kernel, {n_sph + 6} objects, the launch's camera "
              f"rays: {ms:.4f} ms/call, {dev:.4f} ms on the device; plain "
              f"{plain_ms:.1f} ms (one run); a ray enters {entered:.2f} of "
              f"{n_sph_chunks} sphere chunks, the 32 rays of a warp together "
              f"{union:.2f} (2,048 warps of the launch); bound "
              f"{b_ms:.4f} ms ({b_by}); on {smi}; that launch vs the "
              f"plain run:")
        stats = compare_scan(scan(), want)
        max_err[k_scan] = max(max_err[k_scan], stats["max_abs_err"])
        if n_sph == 1000:
            timing[k_scan] = (ms, plain_ms)
            bounds[k_scan] = (b_ms, b_by)

    # ---- phase 14: the skybox kernel alone vs its plain version ----
    sky_tmp = tempfile.TemporaryDirectory()
    write_sky_faces(sky_tmp.name, SEED)
    sky_scenes = {}
    for name in SKY_SCENES:
        path = os.path.join(sky_tmp.name, f"{name}_sky.txt")
        with open(path, "w") as f:
            f.write(sky_scene_text(name))
        sky_scenes[name] = (path, load_scene_file(path, device=device))
    sky = sky_scenes["cornell"][1]
    if (sky.spec.face_sizes != FACE_SIZES
            or sky.data.bg_cube.shape != (6, 1024, 1024, 3)
            or (sky.spec.width, sky.spec.antialias) != (1024, 16)):
        raise AssertionError("the skybox scene did not build as written")
    n = 1 << 21
    # random directions, with exact ties for the largest component (black),
    # axis-aligned directions and directions with a zero component; and
    # the primary rays of the cornell sky launch, pixel-ordered
    dirs = sky_random_directions(n, SEED, device)
    coherent = sky_coherent_directions(sky, device)

    def sky_check(data, rd, label):
        """One call of the skybox kernel's wrapper, which must launch it
        once and nothing else, against _skybox on the same cube."""
        before = dict(megakernel.LAUNCHES)
        got = backgrounds.background_color(data, sky.spec, rd)
        torch.cuda.synchronize()
        rose = {k: megakernel.LAUNCHES[k] - before[k]
                for k in megakernel.KERNELS}
        if rose != {k: int(k == k_sky) for k in megakernel.KERNELS}:
            raise AssertionError(f"background_color launches: {rose}")
        want = backgrounds._skybox(data.bg_cube, sky.spec, rd)
        d = (got - want).abs()
        stats = {
            "directions": rd.shape[0],
            "share_within_1e-6": float((d <= 1e-6).all(dim=1).float().mean()),
            "share_bit_equal": float((got == want).all(dim=1).float().mean()),
            "max_abs_err": float(d.max()),
            "finite": bool(torch.isfinite(got).all()),
            "mean": float(got.mean())}
        print(f"    {label}: {stats}")
        if not (stats["share_within_1e-6"] >= 0.999 and stats["finite"]
                and stats["mean"] > 0.1):
            raise AssertionError(f"skybox kernel disagrees: {stats}")
        max_err[k_sky] = max(max_err[k_sky], stats["max_abs_err"])
        return got

    print(f"[14, {at()}] skybox kernel vs plain, six faces {FACE_SIZES} "
          f"(rule: within 1e-6 on 99.9% of the directions; the share equal "
          f"to the bit beside it):")
    got = sky_check(sky.data, dirs, f"{n} random directions")
    if got[:2048].any():
        raise AssertionError("a tie for the largest component is not black")
    sky_check(sky.data, coherent, f"{coherent.shape[0]} primary-ray "
                                  f"directions of the cornell sky launch")
    # the kernel's entry point, background_color on CUDA tensors, on those
    # directions: its launches in that run (the render kernels and the
    # ring's call sky_lookup inline)
    for k in megakernel.LAUNCHES:
        megakernel.LAUNCHES[k] = 0
    backgrounds.background_color(sky.data, sky.spec, coherent)
    torch.cuda.synchronize()
    sky_entry_launches = megakernel.LAUNCHES[k_sky]
    # the cube changed in place between two calls, as a fitting step
    # changes it: the packed faces follow, in both kernels that read them
    moved = dataclasses.replace(sky.data, bg_cube=sky.data.bg_cube.clone())
    first = backgrounds.background_color(moved, sky.spec, dirs)
    lanes_m = random_lanes(sky.spec, 65536, SEED, device)
    lin_first = megakernel.radiance_lanes(moved, sky.spec, *lanes_m, SEED)
    with torch.no_grad():
        moved.bg_cube[3].mul_(0.5)
        moved.bg_cube[4].add_(0.25)
    again = sky_check(moved, dirs, "the same after the cube changed in place")
    if torch.equal(again, first):
        raise AssertionError("the skybox kernel did not follow the cube")
    stats = check_kernel(megakernel, k_lin, moved, sky.spec, lanes_m, SEED,
                         "cornell under the sky, after the cube changed in "
                         "place")
    if torch.equal(torch.stack(list(lin_first)), torch.stack(list(
            megakernel.radiance_lanes(moved, sky.spec, *lanes_m, SEED)))):
        raise AssertionError("the linear kernel did not follow the cube")
    max_err[k_lin_sky] = max(max_err[k_lin_sky], stats["max_abs_err"])
    del moved, first, again, lin_first

    def sky_kernel():
        return backgrounds.background_color(sky.data, sky.spec, dirs)

    def sky_plain():
        return backgrounds._skybox(sky.data.bg_cube, sky.spec, dirs)

    ms, plain_ms, times = time_pair(sky_kernel, sky_plain, 20, 5)
    k_dev = device_ms(sky_kernel, 20, "skybox")
    coherent_ms = [ms_per_launch(lambda: backgrounds.background_color(
        sky.data, sky.spec, coherent), 3, 20) for _ in range(2)]
    timing[k_sky] = (ms, plain_ms)
    bounds[k_sky] = bound(FLOPS_SKY * n, (24 + SKY_TEXEL_BYTES) * n)
    # what a random direction must take from device memory: two rows of a
    # face, at least one 32-byte sector each, beside its own 24 B
    floor_ms = (24 + 64) * n / H100_SXM.mem_bytes * 1e3
    sass = k4_sass(cuobjdump_sass(_build.library_path(k_sky)))
    print(f"    random directions: kernel {ms:.4f} ms/call (runs "
          f"{[round(x, 4) for x in times['kernel']]}), {k_dev:.4f} ms on the "
          f"device; plain {plain_ms:.4f} ms/call; bound {bounds[k_sky][0]:.4f} "
          f"ms ({bounds[k_sky][1]}: 48 B of texels and 24 B of direction and "
          f"color per lookup); the sector floor {floor_ms:.4f} ms (two "
          f"sectors and 24 B per lookup); on {smi}")
    print(f"    the {coherent.shape[0]} primary-ray directions: runs "
          f"{[round(x, 4) for x in coherent_ms]} ms/call; on {smi}")
    regs = ptxas_registers(_build.build_logs.get(k_sky, ""), "skybox_kernel")
    print(f"    skybox_kernel: {regs} registers; SASS {sass}")
    # the library yardstick: the whole function through grid_sample, over
    # the six faces stacked once into one image (not timed, as the packed
    # faces are made once per cube)
    cube = sky.data.bg_cube
    stacked = cube.permute(3, 0, 1, 2).reshape(
        1, 3, 6 * cube.shape[1], cube.shape[2]).contiguous()
    lib_out = sky_library_call(cube, FACE_SIZES, dirs, stacked)
    want = sky_plain()
    d = (lib_out - want).abs()
    grid = sky_library_grid(cube, FACE_SIZES, dirs)[0]
    grid_ms = ms_per_launch(lambda: sky_grid_sample(stacked, grid), 3, 20)
    library_ms[k_sky] = ms_per_launch(lambda: sky_library_call(
        cube, FACE_SIZES, dirs, stacked), 3, 20)
    print(f"    library: the face and UV in elementwise ops, then one "
          f"grid_sample over the six faces stacked into a "
          f"{tuple(stacked.shape)} image, {library_ms[k_sky]:.4f} ms/call, "
          f"of which the grid_sample alone {grid_ms:.4f} ms; against "
          f"_skybox: max |d| {float(d.max()):.3e}, "
          f"{float((d <= 1e-6).all(dim=1).float().mean()):.6f} within 1e-6, "
          f"{float((d <= 1e-4).all(dim=1).float().mean()):.6f} within 1e-4, "
          f"{float((lib_out == want).all(dim=1).float().mean()):.6f} equal to "
          f"the bit (its weights round their own way); on {smi}")
    del stacked, lib_out, want, d, grid

    # ---- phase 15: the sky instances of the render kernels vs plain ----
    def near_edge_share(data, spec, lanes, seed):
        """Of the primary rays that miss, the share whose two largest
        components lie within 1e-6 relative: a last-bit difference in
        the direction can send such a ray to another face."""
        ro, rd, _, _ = primary_rays(data, spec,
                                    *megakernel.lane_args((*lanes, seed)))
        miss = ~closest_hit(data, spec, ro, rd).hit
        a = torch.stack(list(rd)).abs().sort(dim=0).values
        near = (a[2] - a[1]) <= 1e-6 * a[2]
        return (float(miss.float().mean()),
                float((near & miss).float().sum() / miss.sum().clamp(min=1)))

    print(f"[15, {at()}] "
          "sky instances vs plain (65,536 random lanes, then the "
          "CLI's own launch):")
    for name, kname, row, every in (
            ("cornell", k_lin, k_lin_sky, 1),
            ("showcase", k_tree, k_tree_sky, 1),
            ("field_linear", k_lin, None, 1),
            ("field_mixed", k_tree, None, 8)):
        sc = sky_scenes[name][1]
        if megakernel.is_large(sc.spec) != name.startswith("field"):
            raise AssertionError(f"{name}: wrong regime")
        launch, s_launch = cli_launch_lanes(sc.spec, device, every=every)
        for label, lanes in (
                ("65,536 random lanes",
                 random_lanes(sc.spec, 65536, SEED, device)),
                (f"the CLI's launch, {sc.spec.width}x{sc.spec.height} x "
                 f"{s_launch} aa x {sc.spec.cam_samples} lens"
                 + (f", every {every}th pixel" if every > 1 else ""),
                 (launch,))):
            t0 = time.perf_counter()
            stats = check_kernel(megakernel, kname, sc.data, sc.spec, lanes,
                                 SEED, f"{name} under the sky, {label}")
            miss, near = near_edge_share(sc.data, sc.spec, lanes, SEED)
            print(f"    ({time.perf_counter() - t0:.2f} s; {miss:.4f} of the "
                  f"primary rays miss, {near:.2e} of those within 1e-6 of a "
                  f"face edge)")
            if row is not None:
                max_err[row] = max(max_err[row], stats["max_abs_err"])

    # ---- phase 16: skybox scenes through the CLI ----
    print(f"[16, {at()}] "
          "the CLI on the skybox scenes, from scene files and BMP "
          "faces:")
    sky_launches = {}
    for name, kname, row in (("cornell", k_lin, k_lin_sky),
                             ("showcase", k_tree, k_tree_sky),
                             ("field_linear", k_lin, None),
                             ("field_mixed", k_tree, None)):
        path, sc = sky_scenes[name]
        done, wall, launches, size = cli_render(cli, megakernel, kname, path,
                                                [], sc.spec)
        if row is not None:
            sky_launches[row] = launches[kname]
        s_ = sc.spec
        print(f"    {name}: {s_.width}x{s_.height} x {s_.antialias} aa x "
              f"{s_.cam_samples} lens, {len(s_.live_objects())} objects: "
              f"{wall:.2f} s wall, {done['seconds']} s render ("
              f"{done['seconds_profiled']} s under the profiler, the device "
              f"busy {done['device_busy']:.3f} of that), launches "
              f"{launches}, mean radiance {done['mean_radiance']:.6f}, BMP "
              f"{size} B, on {smi}")

    # ---- phase 17: the sky instances at 2,097,152 lanes per launch ----
    print(f"[17, {at()}] "
          "2,097,152 lanes per launch, skybox scenes, and the solid "
          "scenes again:")
    lanes_c = [t.to(torch.int32)
               for t in pixel_lanes(1024, (1 << 21) // 16, 16, 1, device)]
    lanes_s = [t.to(torch.int32)
               for t in random_lanes(show.spec, 1 << 21, SEED, device)]
    for row, label, sc, lanes, k_reps, p_reps in (
            (k_lin_sky, "linear kernel, cornell under the sky",
             sky_scenes["cornell"][1], lanes_c, 20, 5),
            (k_tree_sky, "tree kernel, showcase under the sky",
             sky_scenes["showcase"][1], lanes_s, 10, 1)):
        def kernel():
            return megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 0)

        def plain():
            return megakernel.radiance_lanes_reference(sc.data, sc.spec,
                                                       *lanes, 0)

        print(f"    {label}, that launch vs the plain run:")
        stats = compare(kernel(), plain(), exact=row == k_tree_sky)
        max_err[row] = max(max_err[row], stats["max_abs_err"])
        ms, plain_ms, times = time_pair(kernel, plain, k_reps, p_reps)
        k_dev = device_ms(kernel, k_reps, megakernel.kernel_for(sc.spec))
        work = path_work(sc.data, sc.spec, lanes, 0)
        timing[row] = (ms, plain_ms)
        bounds[row] = render_bound(sc.spec, 1 << 21, work)
        if row == k_lin_sky:
            bounds[row] = k1_report("open cornell under the sky", "sky",
                                    sc.spec, 1 << 21, work, ms, lin_sass,
                                    lin_log, smi)
        print(f"    {label}: kernel {ms:.4f} ms/call (runs "
              f"{[round(x, 4) for x in times['kernel']]}), {k_dev:.4f} ms on "
              f"the device; plain {plain_ms:.4f} ms/call; needs "
              f"{work['visits']:.3f} live nodes and {work['misses']:.3f} "
              f"skybox lookups per lane; bound {bounds[row][0]:.4f} ms "
              f"({bounds[row][1]}); on {smi}")
    for label, sc_data, sc_spec, lanes, reps in (
            ("cornell, solid", data, spec_b, lanes_c, 20),
            ("showcase, solid", show.data, show.spec, lanes_s, 10)):
        def kernel():
            return megakernel.radiance_lanes(sc_data, sc_spec, *lanes, 0)

        runs = [ms_per_launch(kernel, 3, reps) for _ in range(2)]
        print(f"    {label}: kernel {min(runs):.4f} ms/call (runs "
              f"{[round(x, 4) for x in runs]}); on {smi}")

    # ---- phase 18: gradients and inverse rendering ----
    fields = [f.name for f in dataclasses.fields(SceneData)]

    def leaf_grads(fn, data, *args):
        """Gradient of the sum of ``fn``'s radiance for every float leaf
        of ``data`` (None where a leaf takes none), and the kernel
        launches the call made."""
        leaves = {n: getattr(data, n).detach().clone().requires_grad_(True)
                  for n in fields}
        before = sum(megakernel.LAUNCHES.values())
        out = fn(SceneData(**leaves), *args)
        launched = sum(megakernel.LAUNCHES.values()) - before
        grads = torch.autograd.grad(out.x.sum() + out.y.sum() + out.z.sum(),
                                    list(leaves.values()), allow_unused=True)
        return grads, launched

    def close(g, w):
        return bool(torch.isfinite(g).all()
                    and torch.allclose(g, w, rtol=1e-5, atol=1e-6))

    print(f"[18, {at()}] "
          "gradients: forward through the kernel and backward through "
          "its plain version, vs the plain version alone (rtol 1e-5, atol "
          "1e-6):")
    for label, sc, n_lanes in (
            ("linear kernel, cornell", scene, 16384),
            ("linear kernel, cornell under the sky",
             sky_scenes["cornell"][1], 16384),
            ("tree kernel, showcase", show, 16384),
            ("linear kernel (large), 1,006-object field", lin, 4096)):
        lanes = random_lanes(sc.spec, n_lanes, SEED, device)
        got, launched = leaf_grads(megakernel.radiance_lanes, sc.data,
                                   sc.spec, *lanes, SEED)
        want, none = leaf_grads(megakernel.radiance_lanes_reference, sc.data,
                                sc.spec, *lanes, SEED)
        if (launched, none) != (1, 0):
            raise AssertionError(f"{label}: launches {launched}, {none}")
        worst, moved = 0.0, []
        for n_, g, w in zip(fields, got, want):
            if (g is None) != (w is None):
                raise AssertionError(f"{label}: {n_} took a gradient on one "
                                     f"side only")
            if g is None:
                continue
            if not close(g, w):
                raise AssertionError(
                    f"{label}: gradient of {n_} differs by "
                    f"{float((g - w).abs().max())}")
            worst = max(worst, float((g - w).abs().max()))
            if float(g.abs().max()) > 0:
                moved.append(n_)
        if not moved:
            raise AssertionError(f"{label}: every gradient is zero")
        print(f"    {label}, {n_lanes} lanes: equal, largest difference "
              f"{worst:.3e}; nonzero for {', '.join(moved)}")
    tb = scene_tables(lin.data, lin.spec)
    o, d_, _, _ = primary_rays(lin.data, lin.spec,
                               *random_lanes(lin.spec, 16384, SEED, device),
                               SEED)
    scan_grads = []
    for fn in (intersect_scan.scan_hit, intersect_scan.scan_hit_reference):
        leaves = [tb.table.detach().clone().requires_grad_(True),
                  *(c.detach().clone().requires_grad_(True)
                    for c in (*o, *d_))]
        before = megakernel.LAUNCHES[k_scan]
        t, _, hit = fn(leaves[0], tb.ids, tb.n_sph_pad, V3(*leaves[1:4]),
                       V3(*leaves[4:7]))
        if (megakernel.LAUNCHES[k_scan] - before
                != int(fn is intersect_scan.scan_hit)):
            raise AssertionError("scan_hit under autograd: wrong launches")
        scan_grads.append(torch.autograd.grad(
            torch.where(hit, t, 0.0).sum(), leaves))
    if not all(close(g, w) for g, w in zip(*scan_grads)):
        raise AssertionError("scan_hit: the kernel's gradient of t differs")
    print(f"    scan kernel, 16,384 camera rays of the 1,006-object field: "
          f"gradient of t equal for table, origins and directions, largest "
          f"table gradient {float(scan_grads[0][0].abs().max()):.4f}")

    def fit_check(label, sc, kname, object_rows, new_rows, min_gain, atol,
                  steps=40):
        """Perturb one diffuse row and one ambient row, fit both leaves
        back to the scene's own render at 256x256 with 4 samples per
        pixel; then time one more step's forward and backward alone."""
        spec_f = dataclasses.replace(sc.spec, width=256, height=256)
        pix = torch.arange(256 * 256, dtype=torch.int64, device=device)
        px, py = pix % 256, pix // 256
        sids = torch.arange(4, dtype=torch.int64, device=device)
        n_lanes = 256 * 256 * 4 * spec_f.cam_samples
        target = sample_pixels(sc.data, spec_f, px, py, sids, 0)
        names = ("mat_diffuse", "mat_ambient")
        moved = {}
        for leaf, row, value in zip(names, object_rows, new_rows):
            moved[leaf] = getattr(sc.data, leaf).clone()
            moved[leaf][row] = torch.tensor(value, device=device)
        perturbed = dataclasses.replace(sc.data, **moved)
        mask = SceneData(**{n: n in names for n in fields})
        for k in megakernel.LAUNCHES:
            megakernel.LAUNCHES[k] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fitted, hist = optim.fit(
            perturbed, spec_f, px, py, target, seed=0, steps=steps, spp=4,
            trainable=mask, vary_seed=False,
            optimizer=lambda ps: torch.optim.Adam(ps, lr=0.03,
                                                  betas=(0.8, 0.99)))
        torch.cuda.synchronize()
        per_step = (time.perf_counter() - t0) / steps
        peak = torch.cuda.max_memory_allocated()
        if megakernel.LAUNCHES[kname] != steps:
            raise AssertionError(f"{label}: {dict(megakernel.LAUNCHES)} "
                                 f"launches in {steps} steps")
        errs = [float((getattr(fitted, leaf)[row]
                       - getattr(sc.data, leaf)[row]).abs().max())
                for leaf, row in zip(names, object_rows)]
        worst = max(float((getattr(fitted, leaf) - getattr(sc.data, leaf))
                          .abs().max()) for leaf in names)
        gain = hist[0] / max(hist[-1], 1e-30)
        # the same fit with fit's own defaults (Adam, learning rate 1e-2,
        # betas 0.9/0.999): the same gradients under another optimiser
        fitted_d, hist_d = optim.fit(perturbed, spec_f, px, py, target,
                                     seed=0, steps=steps, spp=4,
                                     trainable=mask, vary_seed=False)
        errs_d = [float((getattr(fitted_d, leaf)[row]
                         - getattr(sc.data, leaf)[row]).abs().max())
                  for leaf, row in zip(names, object_rows)]
        if not (all(math.isfinite(h) for h in hist_d)
                and hist_d[-1] < hist_d[0]):
            raise AssertionError(f"{label}: the default fit did not descend")
        # one step's two halves: the forward is the kernel and the mean
        # per pixel, the backward the plain version under autograd
        leaves = {n: getattr(fitted, n).detach().requires_grad_(n in names)
                  for n in fields}

        def forward():
            return optim.render_loss(SceneData(**leaves), spec_f, px, py,
                                     sids, 0, target)

        forward()
        fwd_ms, loss = once_ms(forward)
        bwd_ms, _ = once_ms(lambda: torch.autograd.grad(
            loss, [leaves[n] for n in names]))
        lanes = [t.to(torch.int32)
                 for t in pixel_lanes(256, 256 * 256, 4, spec_f.cam_samples,
                                      device)]
        kernel_ms = ms_per_launch(lambda: megakernel.radiance_lanes(
            fitted, spec_f, *lanes, 0), 3, 20)
        per_lane = peak / n_lanes
        print(f"    {label}: {n_lanes} lanes per step, {steps} steps, loss "
              f"{hist[0]:.4f} -> {hist[-1]:.6f} ({gain:.0f}x), perturbed "
              f"rows off by {errs[0]:.4f} (diffuse) and {errs[1]:.4f} "
              f"(ambient), any trained row by at most {worst:.4f}; "
              f"{per_step:.4f} s per step, forward {fwd_ms:.3f} ms (of which "
              f"the kernel's call {kernel_ms:.4f} ms), backward {bwd_ms:.3f} "
              f"ms ({bwd_ms / fwd_ms:.0f}x the forward, "
              f"{bwd_ms / kernel_ms:.0f}x the kernel's call); peak memory "
              f"{peak / 2 ** 30:.3f} GiB = {per_lane:.0f} B per lane, so "
              f"80 GB would hold about {int(80e9 / per_lane)} lanes a step "
              f"(extrapolated); on {smi}")
        print(f"      loss at every 5th step, betas 0.8/0.99 at 0.03: "
              f"{[round(h, 3) for h in hist[::5]]}\n"
              f"      the same with fit's defaults (optimizer=None, learning "
              f"rate 0.01): {[round(h, 3) for h in hist_d[::5]]}, "
              f"{hist_d[0]:.4f} -> {hist_d[-1]:.6f} "
              f"({hist_d[0] / max(hist_d[-1], 1e-30):.1f}x), perturbed rows "
              f"off by {errs_d[0]:.4f} (diffuse) and {errs_d[1]:.4f} "
              f"(ambient)")
        if not (gain >= min_gain and max(errs) <= atol
                and all(math.isfinite(h) for h in hist)):
            raise AssertionError(f"{label}: the fit did not converge")

    print("    inverse rendering (optim.fit, Adam lr 0.03, betas 0.8/0.99, "
          "the seed fixed):")
    fit_check("cornell through the linear kernel", scene, k_lin, (5, 6),
              ([0.75, 0.8, 1.2], [5.0, 5.9, 5.2]), 100.0, 0.03)
    fit_check("lit mirror scene through the linear kernel (lights, mirror, "
              "2 lens samples)", lit, k_lin, (1, 0),
              ([0.5, 0.5, 0.45], [0.2, 0.15, 0.1]), 100.0, 0.05)

    # ---- phase 19: one rank: --shard, --shard-objects (the ring) ----
    from raytrace_tpu_torch.ops import intersect
    from raytrace_tpu_torch.parallel import ring as ringlib
    from raytrace_tpu_torch.parallel.mesh import Mesh
    from raytrace_tpu_torch.render import ring_shade
    from raytrace_tpu_torch.render.integrator import render_image

    print(f"[19, {at()}] one rank on the card: the CLI with --shard, then "
          f"the ring of --shard-objects (the ring instances of K1 and K3, "
          f"K5 per query, misses under the sky looked up inline):")
    one_rank = Mesh(device)

    def cli_bytes(path, args, out):
        if cli.main([path, "-o", out, *args, "--device", "cuda", "-q"]) != 0:
            raise AssertionError(f"CLI {args} failed")
        with open(out, "rb") as f:
            return f.read()

    # the plain version must not run on the card under the ring: every
    # call of it on CUDA tensors is counted
    plain_on_card = []
    real_reference = megakernel.radiance_lanes_reference

    def guarded_reference(data, *args):
        if data.device.type == "cuda":
            plain_on_card.append(str(data.device))
        return real_reference(data, *args)

    @contextlib.contextmanager
    def no_plain_on_card(label):
        megakernel.radiance_lanes_reference = guarded_reference
        try:
            yield
        finally:
            megakernel.radiance_lanes_reference = real_reference
        if plain_on_card:
            raise AssertionError(f"{label}: the plain version ran on the "
                                 f"card {len(plain_on_card)} times")

    def image_s(fn, reps=3):
        """The best of ``reps`` calls' seconds, by CUDA events."""
        return min(once_ms(fn)[0] for _ in range(reps)) / 1e3

    with tempfile.TemporaryDirectory() as tmp:
        for label, path, args in (("cornell", SCENE, ["--spp", "16"]),
                                  ("showcase", SHOWCASE, [])):
            t0 = time.perf_counter()
            plain = cli_bytes(path, args, os.path.join(tmp, "plain.bmp"))
            t1 = time.perf_counter()
            sharded = cli_bytes(path, [*args, "--shard"],
                                os.path.join(tmp, "shard.bmp"))
            t2 = time.perf_counter()
            print(f"    {label}: --shard BMP {len(sharded)} B, equal to the "
                  f"plain CLI's byte for byte: {sharded == plain} "
                  f"({t2 - t1:.2f} s against {t1 - t0:.2f} s wall)")
            if sharded != plain:
                raise AssertionError(f"{label}: --shard changed the BMP")
        ring_launches = {}
        for label, mix in (("linear", False), ("mixed", True)):
            path = os.path.join(tmp, f"ring_{label}.txt")
            with open(path, "w") as f:
                f.write(sphere_field_source(1000, mix_materials=mix,
                                            width=256, height=256,
                                            antialias=4))
            sc = load_scene_file(path, device=device)
            calls = ring_calls(sc.spec, 4, 1)
            # the CLI's seed is 0, and one call renders every lane
            rounds = ring_rounds(sc, calls, pixel_lanes(
                256, 256 * 256, 4, sc.spec.cam_samples, device), 0)
            want = expected_ring_launches(sc.spec, calls, rounds)
            for k in megakernel.LAUNCHES:
                megakernel.LAUNCHES[k] = 0
            t0 = time.perf_counter()
            with no_plain_on_card(f"--shard-objects, {label} field"):
                cli_bytes(path, ["--shard-objects"],
                          os.path.join(tmp, "ring.bmp"))
            wall = time.perf_counter() - t0
            rose = ring_launches[label] = dict(megakernel.LAUNCHES)
            print(f"    --shard-objects, the {label} field at 256x256 x 4 "
                  f"spp: launches {rose} in {wall:.2f} s wall ({calls} "
                  f"sample_pixels call(s) of {rounds} rounds, counted on "
                  f"the plain walk; expected {want}), no plain version on "
                  f"the card")
            if ({k: rose[k] for k in want} != want
                    or rose[k_lin] or rose[k_tree] or rose[k_sky]):
                raise AssertionError(f"the ring's launches {rose}")
            with no_plain_on_card(f"render_image_ring, {label} field"):
                ring_img = ringlib.render_image_ring(sc, seed=SEED,
                                                     mesh=one_rank)
                ring_s = image_s(lambda: ringlib.render_image_ring(
                    sc, seed=SEED, mesh=one_rank))
            fused = render_image(sc, seed=SEED)
            fused_s = image_s(lambda: render_image(sc, seed=SEED))
            print(f"    render_image_ring {ring_s:.4f} s per image against "
                  f"the fused {k_lin if not mix else k_tree} (large) "
                  f"{fused_s:.4f} s; on {smi}; the ring's image vs the "
                  f"fused kernel's, per pixel:")
            compare(torch.from_numpy(ring_img.reshape(-1, 3).T),
                    torch.from_numpy(fused.reshape(-1, 3).T))
    def twin_image(sc, spp):
        """(3, P) pixel means of every lane of ``sc``'s image through the
        ring's round loop with the plain twin as its step, as
        sample_pixels makes them."""
        from raytrace_tpu_torch.render.integrator import lane_ids

        w, h = sc.spec.width, sc.spec.height
        pix = torch.arange(w * h, device=device)
        lanes = lane_ids(pix % w, pix // w, torch.arange(spp, device=device),
                         sc.spec.cam_samples)
        with ringlib.ring_context(sc.data, sc.spec, one_rank) as st:
            rad = ringlib.ring_radiance(intersect.ring_ctx(), st, sc.spec,
                                        *lanes, SEED,
                                        step=ring_shade.ring_shade_reference)
        return torch.stack([r.reshape(w * h, -1).mean(dim=1) for r in rad])

    # two more ring renders through render_image_ring at 256x256 x 4 spp:
    # the linear field opened under the sky, its misses looked up inline by
    # the ring's sky instance, held to K1-large+sky; and the lit mirror
    # scene, whose shadow rays ring_shadow writes, held to the twin's image
    # (K1 parts from the plain version on 0.2% of this scene's lanes,
    # phase 6, too many for the rule on pixels of eight lanes each)
    lit_mirror = build_scene(dsl.parse(LIT_MIRROR), device=device)
    for label, sc in (("the linear field under the sky",
                       sky_scenes["field_linear"][1]),
                      ("the lit mirror scene (two lights, DoF)", lit_mirror)):
        sc = dataclasses.replace(sc, spec=dataclasses.replace(
            sc.spec, width=256, height=256))
        calls = ring_calls(sc.spec, 4, 1)
        want = expected_ring_launches(sc.spec, calls, ring_rounds(sc, calls))
        for k in megakernel.LAUNCHES:
            megakernel.LAUNCHES[k] = 0
        with no_plain_on_card(f"render_image_ring, {label}"):
            ring_img = ringlib.render_image_ring(sc, seed=SEED, spp=4,
                                                 mesh=one_rank)
        rose = dict(megakernel.LAUNCHES)
        if ({k: rose[k] for k in want} != want
                or rose[k_lin] or rose[k_tree] or rose[k_sky]):
            raise AssertionError(f"{label}: the ring's launches {rose}, "
                                 f"expected {want}")
        if sc.spec.n_lights:
            ring_launches["lit"] = rose
        ring_s = image_s(lambda: ringlib.render_image_ring(
            sc, seed=SEED, spp=4, mesh=one_rank))
        fused = render_image(sc, seed=SEED, spp=4)
        fused_s = image_s(lambda: render_image(sc, seed=SEED, spp=4))
        print(f"    render_image_ring, {label}, 256x256 x 4 spp: launches "
              f"{rose} (expected {want}), {ring_s:.4f} s against the fused "
              f"{fused_s:.4f} s; on {smi}; vs the "
              f"{'twin' if sc.spec.n_lights else 'fused kernel'}, per "
              f"pixel:")
        compare(torch.from_numpy(ring_img.reshape(-1, 3).T),
                twin_image(sc, 4) if sc.spec.n_lights
                else torch.from_numpy(fused.reshape(-1, 3).T))

    # the ring instances against their plain twin (the same round loop
    # with ring_shade_reference as its step): the tree to the bit, the
    # linear instance by the K1 rule (it is built without contraction,
    # so its bit-equal share is printed beside it)
    print(f"    the ring instances vs their plain twin "
          f"(ring_shade_reference), {n_chk} random lanes unless said:")
    deep = build_scene(dsl.parse(INDIRECT4.replace(
        "samples: 4", f"samples: {RING_DEEP_SAMPLES}")), device=device)
    deep = dataclasses.replace(deep, spec=dataclasses.replace(deep.spec,
                                                              max_depth=0))
    for label, sc, n_lanes in (
            ("1,006-object linear field", lin, n_chk),
            ("1,006-object mixed field", mixed, n_chk),
            ("lit mirror + DoF", lit_mirror, n_chk),
            ("open linear field under the sky", sky_scenes["field_linear"][1],
             n_chk),
            (f"{RING_DEEP_SAMPLES}-sample IndirectPhong sphere, max_depth 0 "
             f"(stacks of {ring_shade.stack_entries(deep.spec)} entries)",
             deep, RING_DEEP_LANES)):
        lanes_r = random_lanes(sc.spec, n_lanes, SEED, device)
        row = k_ring_lin if sc.spec.children_per_ray <= 1 else k_ring_tree
        with ringlib.ring_context(sc.data, sc.spec, one_rank) as st:
            before = megakernel.LAUNCHES[k_ring]
            t0 = time.perf_counter()
            with no_plain_on_card(f"the ring instances, {label}"):
                got = megakernel.radiance_lanes(st, sc.spec, *lanes_r, SEED)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            n_launch = megakernel.LAUNCHES[k_ring] - before
            want = ringlib.ring_radiance(
                intersect.ring_ctx(), st, sc.spec, *lanes_r, SEED,
                step=ring_shade.ring_shade_reference)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        print(f"    {label}, {n_lanes} lanes: {n_launch} ring kernel "
              f"launches, {t1 - t0:.3f} s (the twin {t2 - t1:.3f} s):")
        stats = compare(got, want, exact=row == k_ring_tree)
        max_err[row] = max(max_err[row], stats["max_abs_err"])
        del got, want
    torch.cuda.empty_cache()

    # a round of the ring kernels at 2,097,152 lanes (the first: every lane
    # live), each kernel against its plain version on the same inputs, to
    # the bit: pixel-ordered lanes of the 1,006-object fields (the linear
    # field's round times ring_start and ring_rows, each field's its
    # ring_finish), and random lanes of the lit mirror scene (ring_shadow)
    n = 1 << 21
    lanes_p = [t.to(torch.int32) for t in pixel_lanes(1024, n // 2, 2, 1,
                                                      device)]
    lanes_l = [t.to(torch.int32)
               for t in random_lanes(lit_mirror.spec, n, SEED, device)]
    for label, sc, lanes_r, times in (
            ("the 1,006-object linear field", lin, lanes_p,
             {"ring_start": k_ring_start, "ring_rows": k_ring_rows,
              "ring_finish": k_ring_lin}),
            ("the 1,006-object mixed field", mixed, lanes_p,
             {"ring_finish": k_ring_tree}),
            ("the lit mirror scene, random lanes", lit_mirror, lanes_l,
             {"ring_shadow": k_ring_shadow})):
        r = ring_round(ringlib, ring_shade, intersect, sc, lanes_r, one_rank)
        print(f"    a round at {n} lanes, {label}: the round's scan kernel "
              f"{r.pop('scan_ms'):.4f} ms; on {smi}:")
        for kname, e in r.items():
            forms = [("", e)] + ([(" (int64 ids)", e["int64"])]
                                 if "int64" in e else [])
            for form, f in forms:
                b_ms, b_by = f.get("bound", bound(0.0, f["bytes"]))
                what = ("the primary rays' operations counted"
                        if "bound" in f else "the shading's operations left "
                        "out")
                lib = (f", torch.index_select {f['library_ms']:.4f} ms"
                       if "library_ms" in f else "")
                bare = (f"; bare launch {f['bare_ms']:.4f} ms (slowest "
                        f"{f['bare_slowest']:.4f}); the wrapper's host work "
                        f"{f['host_ms']:.4f} ms" if "bare_ms" in f else "")
                print(f"      {kname}{form}: wrapper {f['ms']:.4f} ms "
                      f"(slowest of {RING_REPS} {f['ms_slowest']:.4f}){bare}, "
                      f"plain {f['plain_ms']:.4f} ms{lib}; equal to the plain "
                      f"version to the bit: {f['equal']} (largest difference "
                      f"{f['max_abs_err']}); bound {b_ms:.4f} ms ({b_by}: "
                      f"{f['bytes']} B; {what})")
            if not e["equal"]:
                raise AssertionError(f"{kname} differs from its plain "
                                     f"version on {label}")
            row = times.get(kname)
            if row is not None:
                timing[row] = (e["ms"], e["plain_ms"])
                bounds[row] = e.get("bound", bound(0.0, e["bytes"]))
                max_err[row] = max(max_err[row], e["max_abs_err"])
                if "library_ms" in e:
                    library_ms[row] = e["library_ms"]
                if "bare_ms" in e:
                    bare_ms[row] = e["bare_ms"]
    del lanes_p, lanes_l
    torch.cuda.empty_cache()
    # K5 per ring step on the 4,006-object field: the whole table against
    # every ray (k = 1), and each half against half the rays (k = 2); the
    # shard's bounds and fold buffer, built once per shard
    sc4 = field4k
    ro, rd = ring_rays(sc4, device)
    for k in (1, 2):
        tables, ids, n_sph = ringlib.shard_geometry(sc4.data, sc4.spec, k)
        for i in range(k):
            shard = ringlib.make_shard(tables[i], ids[i], n_sph)
            build_ms = min(once_ms(lambda: ringlib.make_shard(
                tables[i], ids[i], n_sph))[0] for _ in range(3))
            parts = intersect_scan.fold_ids_bounds(shard.fold, shard.table)
            fold_ms = min(once_ms(lambda: intersect_scan.fold_buffer(
                shard.table, parts[0], n_sph, parts[1]))[0]
                for _ in range(3))
            n_r = RING_RAYS // k
            o = V3(*ro[i * n_r:(i + 1) * n_r].unbind(1))
            d_ = V3(*rd[i * n_r:(i + 1) * n_r].unbind(1))
            step_ms = min(ms_per_launch(lambda: ringlib._shard_hit(
                shard, n_sph, o, d_), 2, 10) for _ in range(2))
            print(f"    ring step, k = {k}, shard {i} ({tables.shape[1]} "
                  f"rows, {sum(x.numel() * x.element_size() for x in shard)} "
                  f"B with its fold buffer), {n_r} camera rays: "
                  f"K5 {step_ms:.4f} ms; the shard built in {build_ms:.3f} "
                  f"ms, its fold buffer alone {fold_ms:.3f} ms; on {smi}; "
                  f"the step vs the plain scan of the shard:")
            stats = compare_scan(
                ringlib._shard_hit(shard, n_sph, o, d_),
                intersect_scan.scan_hit_reference(shard.table, parts[0],
                                                  n_sph, o, d_))
            max_err[k_scan] = max(max_err[k_scan], stats["max_abs_err"])

    # the ring's gradients at k = 1 against the dense path's: forwards
    # through K5 and ring_rows, backwards through their plain versions;
    # each path's forward and backward timed apart, so that the ring's
    # backward reads beside the plain scan's forward and backward (the
    # dense path's), which it re-runs
    gsc, gro, grd = grad_inputs(device)
    dense_g = path_grads(gsc, gro, grd)
    ring_g = path_grads(gsc, gro, grd, one_rank)
    grad_launches = {"grad_k1": ring_g["launches"]}
    excess, diff = grad_excess(ring_g["grads"], dense_g["grads"])
    print(f"    the ring's gradients at k = 1, {gro.shape[0]} camera rays of "
          f"the 1,006-object field at {GRAD_IMAGE}x{GRAD_IMAGE}: t through "
          f"make_ring_intersector in prim_p, prim_q, ro, rd, and the records "
          f"through ring_closest_hit in the {len(dense_g['grads']['records'])}"
          f" per-object leaves, against the dense path's (the plain scan): "
          f"within the float32 gradient rule: {excess <= 0} (largest "
          f"excess {excess:.3e}, largest difference {diff:.3e}); the "
          f"forwards' launches {ring_g['launches']}, the dense path's "
          f"{dense_g['launches']}; on {smi}")
    for p in ("t", "records"):
        (rf, rb), (df, db) = ring_g["ms"][p], dense_g["ms"][p]
        print(f"    {p}: ms by CUDA events, the best of {GRAD_REPS} after a "
              f"first run: the ring's forward {rf:.4f}, backward {rb:.4f}; "
              f"the dense path's (the plain scan) forward {df:.4f}, "
              f"backward {db:.4f}, the two {df + db:.4f}; the ring's "
              f"backward over them {rb / (df + db):.3f}")
    if (excess > 0 or ring_g["launches"][k_scan] != 2
            or ring_g["launches"]["ring_rows"] != 1):
        raise AssertionError("the ring's gradients at k = 1")
    k1_ms = ring_g["ms"]
    dense_g = {p: [x.cpu() for x in gs] for p, gs in dense_g["grads"].items()}
    del ring_g, gsc, gro, grd
    torch.cuda.empty_cache()

    # ---- phase 20: two ranks on the one card ----
    print(f"[20, {at()}] two ranks on the one card (gloo: NCCL takes one "
          f"card per rank), started as processes of this script under the "
          f"environment protocol:")
    del ro, rd
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = run_ranks(tmp)
        print(f"    both ranks done in {time.perf_counter() - t0:.1f} s")
        with open(os.path.join(tmp, "multi.bmp"), "rb") as f:
            multi = f.read()
        one = cli_bytes(SCENE, ["--spp", "16"], os.path.join(tmp, "one.bmp"))
        print(f"    the multi-process CLI's BMP ({len(multi)} B) equals the "
              f"one-process CLI's byte for byte: {multi == one}")
        if multi != one or any(r["cli_rc"] for r in ranks):
            raise AssertionError("the multi-process BMP differs")
    ring1 = ringlib.make_ring_intersector(field4k.spec, one_rank)(
        field4k.data, *ring_rays(field4k, device))
    for r in ranks:
        same = [torch.equal(a.cpu(), r[n]) for a, n in zip(
            ring1, ("t", "obj", "hit"))]
        print(f"    rank {r['rank']} ({r['backend']}, {r['device']}): the "
              f"ring at k = 2 on {RING_RAYS} rays of the 4,006-object field "
              f"(t, obj, hit) equal to k = 1 to the bit: {same}; hand-off "
              f"of a {r['shard_bytes']} B shard {r['handoff_ms']:.3f} ms "
              f"per step (staged through the host)")
        if not all(same):
            raise AssertionError("the ring at k = 2 differs from k = 1")
        print(f"    rank {r['rank']}: the rows' ring at k = 2 (ring_rows) on "
              f"its {RING_RAYS // RANKS} rays' winners, "
              f"{r['rows_from_the_other_shard']:.3f} of them in the other "
              f"rank's row shard, equal to its plain selects to the bit: "
              f"{r['rows_equal']}")
        if not r["rows_equal"]:
            raise AssertionError("the rows' ring at k = 2 differs from its "
                                 "plain version")
    w, h, spp = RING_IMAGE
    field = make_sphere_field(1000, mix_materials=False, width=w, height=h,
                              device=device)
    t0 = time.perf_counter()
    img1 = torch.from_numpy(ringlib.render_image_ring(
        field, seed=SEED, spp=spp, mesh=one_rank))
    one_s = time.perf_counter() - t0
    for r in ranks:
        print(f"    rank {r['rank']}: ring render {w}x{h} x {spp} spp at "
              f"k = 2 {r['ring_render_s']:.3f} s (k = 1 here {one_s:.3f} s), "
              f"equal to k = 1 to the bit: "
              f"{torch.equal(r['ring_image'], img1)}")
        if not torch.equal(r["ring_image"], img1):
            raise AssertionError("the ring render at k = 2 differs")
    w, h, spp = RING_MIXED_IMAGE
    field = make_sphere_field(1000, mix_materials=True, width=w, height=h,
                              device=device)
    t0 = time.perf_counter()
    img1 = torch.from_numpy(ringlib.render_image_ring(
        field, seed=SEED, spp=spp, mesh=one_rank))
    one_s = time.perf_counter() - t0
    for r in ranks:
        same = torch.equal(r["ring_mixed_image"], img1)
        print(f"    rank {r['rank']}: ring render of the mixed field (the "
              f"tree instance, rounds agreed by a MAX all-reduce) {w}x{h} x "
              f"{spp} spp at k = 2 {r['ring_mixed_render_s']:.3f} s (k = 1 "
              f"here {one_s:.3f} s), equal to k = 1 to the bit: {same}")
        if not same:
            raise AssertionError("the mixed ring render at k = 2 differs")
    data, spec_s, px, py, sids, target = step_inputs(device)
    loss0, g0 = optim.loss_and_grad(data, spec_s, px, py, sids, SEED, target)
    for r in ranks:
        worst = max(float(((r["grads"][n] - getattr(g0, n).cpu()).abs()
                           - STEP_ATOL - STEP_RTOL
                           * getattr(g0, n).cpu().abs()).max())
                    for n in r["grads"])
        loss_rel = abs(float(r["loss"]) - float(loss0)) / abs(float(loss0))
        print(f"    rank {r['rank']}: make_sharded_step loss "
              f"{float(r['loss']):.6f} against loss_and_grad's "
              f"{float(loss0):.6f} (relative {loss_rel:.2e}); every gradient "
              f"within rtol {STEP_RTOL}, atol {STEP_ATOL}: {worst <= 0} "
              f"(largest excess {worst:.2e}); launches {r['launches']}")
        if loss_rel > STEP_RTOL or worst > 0:
            raise AssertionError("the sharded step differs")
    for r in ranks:
        g = r["grads_ring"]
        excess, diff = grad_excess(g["grads"], dense_g)
        ms = "; ".join(
            f"{p} forward {g['ms'][p][0]:.4f}, backward {g['ms'][p][1]:.4f} "
            f"(k = 1 here {k1_ms[p][0]:.4f}, {k1_ms[p][1]:.4f})"
            for p in ("t", "records"))
        print(f"    rank {r['rank']}: the ring's gradients at k = 2 (each "
              f"rank's records of its half of the rays) within the float32 "
              f"gradient rule of the dense path's: {excess <= 0} (largest "
              f"excess {excess:.3e}, largest difference {diff:.3e}); the "
              f"forwards' launches {g['launches']}; ms by CUDA events, the "
              f"best of {GRAD_REPS} after a first run, the two ranks "
              f"time-sharing the card: {ms}")
        if (excess > 0 or g["launches"][k_scan] != 2 * RANKS
                or g["launches"]["ring_rows"] != RANKS):
            raise AssertionError("the ring's gradients at k = 2")
    for r in ranks:
        for name, c in r["checkpoint"].items():
            print(f"    rank {r['rank']}: {name}, {CK_IMAGE[0]}x"
                  f"{CK_IMAGE[1]} x {CK_IMAGE[2]} spp with a checkpoint: "
                  f"stopped after the group at {c['seen'][0]:.4f} of the "
                  f"samples, resumed equal to the uncheckpointed image to "
                  f"the bit: {c['equal']} (mean {c['mean']:.6f}); another "
                  f"seed refused: {c['refused'] is not None}; this rank's "
                  f"file exists: {c['file']}")
            if not (c["equal"] and len(c["seen"]) == 2
                    and c["refused"] is not None
                    and "different render config" in c["refused"]
                    and c["file"] == (r["rank"] == 0)):
                raise AssertionError(f"rank {r['rank']}: {name} with a "
                                     f"checkpoint")
    grad_launches["grad_k2_rank0"] = ranks[0]["grads_ring"]["launches"]

    # ---- phase 21: deep trees, K3's stacks above 64 entries ----
    print(f"[21, {at()}] deep fan-out trees: the tree kernel's 128- and "
          f"256-entry stacks and its slab, vs the plain version to the bit:")
    torch.cuda.empty_cache()
    deep_launches = {}
    slab_vs_local = []
    deep_rows = {128: k_tree_128, 256: k_tree_256,
                 megakernel.TREE_SLAB: k_tree_slab}
    tree_log = _build.build_logs.get(k_tree, "")
    for samples in DEEP_SAMPLES:
        text = INDIRECT4.replace("samples: 4", f"samples: {samples}")
        field_text = sphere_field_source(1000, mix_materials=False).replace(
            "samples: 1", f"samples: {samples}")
        variants = {"solid": text, "sky": under_the_sky(text),
                    "1,006-object field": field_text}
        for vname, vtext in variants.items():
            path = os.path.join(sky_tmp.name, f"deep_{samples}_{vname[:3]}.txt")
            with open(path, "w") as f:
                f.write(vtext)
            sc = load_scene_file(path, device=device)
            sc = dataclasses.replace(sc, spec=dataclasses.replace(
                sc.spec, max_depth=0))
            m, levels, nodes, cap = tree_loop_stack(sc.spec)
            inst = megakernel.tree_instance(cap)
            row = deep_rows[inst]
            large = 0
            if megakernel.is_large(sc.spec):
                large = 1 + int(intersect_scan.fold_in_shared(
                    scene_tables(sc.data, sc.spec).table.shape[0] // 32,
                    megakernel.scene_shared_bytes(sc.spec)))
            attrs = megakernel.tree_instance_attrs(inst, large,
                                                   vname == "sky")
            mangled = (f"megakernel_treeILi{inst}ELi{large}"
                       f"ELb{int(vname == 'sky')}E")
            n = 16384 if vname == "solid" and samples < 256 else 4096
            lanes = random_lanes(sc.spec, n, SEED, device)
            t0 = time.perf_counter()
            want = megakernel.radiance_lanes_reference(sc.data, sc.spec,
                                                       *lanes, SEED)
            print(f"    {samples}-sample IndirectPhong, {vname}, max_depth 0: "
                  f"m={m}, {nodes} nodes, stack {cap}, instance "
                  f"{'slab' if inst == megakernel.TREE_SLAB else inst} "
                  f"({mangled}: {ptxas_registers(tree_log, mangled)} "
                  f"registers, {ptxas_frame(tree_log, mangled)} B stack "
                  f"frame; the runtime: {attrs}); {n} random lanes:")
            stats = check_kernel(megakernel, k_tree, sc.data, sc.spec, lanes,
                                 SEED, f"{vname}, its own instance", want)
            max_err[row] = max(max_err[row], stats["max_abs_err"])
            if inst != megakernel.TREE_SLAB:
                # the same lanes through the slab form
                with forced_slab(megakernel):
                    stats = check_kernel(megakernel, k_tree, sc.data,
                                         sc.spec, lanes, SEED,
                                         f"{vname}, the slab form", want)
                max_err[k_tree_slab] = max(max_err[k_tree_slab],
                                           stats["max_abs_err"])
            print(f"    ({time.perf_counter() - t0:.2f} s)")
            if vname != "solid":
                continue
            # DEEP_LANES random lanes: the kernel (and, where a local stack
            # is the instance, the slab form, in turns), then one plain run,
            # which every timed output is held against
            big = [t.to(torch.int32)
                   for t in random_lanes(sc.spec, DEEP_LANES, SEED, device)]

            def kernel():
                return megakernel.radiance_lanes(sc.data, sc.spec, *big, 0)

            def plain():
                return megakernel.radiance_lanes_reference(sc.data, sc.spec,
                                                           *big, 0)

            forms = ["own", "slab", "slab", "own"] if (
                inst != megakernel.TREE_SLAB) else ["own", "own"]
            times = {"own": [], "slab": []}
            outs = {}
            for form in forms:
                if form == "slab":
                    with forced_slab(megakernel):
                        times[form].append(ms_per_launch(kernel, 1, 3))
                        outs[form] = kernel()
                else:
                    times[form].append(ms_per_launch(kernel, 1, 3))
                    outs[form] = kernel()
            plain_ms, want = once_ms(plain)
            for form, out in outs.items():
                print(f"    {DEEP_LANES} lanes, {form} form vs the plain run:")
                compare(out, want, exact=True)
            del want, outs
            torch.cuda.empty_cache()
            work = path_work(sc.data, sc.spec, big, 0)
            b = render_bound(sc.spec, DEEP_LANES, work)
            ms = min(times["own"])
            timing[row] = (ms, plain_ms)
            bounds[row] = b
            if times["slab"]:
                slab_vs_local.append((cap, ms, min(times["slab"])))
            print(f"    {samples}-sample, {DEEP_LANES} random lanes: kernel "
                  f"{ms:.4f} ms/call (runs {[round(x, 4) for x in times['own']]}"
                  f"), slab form {[round(x, 4) for x in times['slab']]}; "
                  f"plain {plain_ms:.1f} ms (one run); needs "
                  f"{work['visits']:.3f} live nodes per lane, "
                  f"{work['warp_visits']:.3f} the largest of a warp; bound "
                  f"{b[0]:.4f} ms ({b[1]}); on {smi}")
    if any(r not in timing for r in deep_rows.values()):
        raise AssertionError("a deep instance was not timed")
    # a tree that returns: the 16-sample sphere over the mirror floor at
    # max_depth 4, through its 128-entry stack and through the slab
    sc = build_scene(dsl.parse(INDIRECT4.replace("samples: 4",
                                                 "samples: 16")), device=device)
    cap = tree_loop_stack(sc.spec)[3]
    big = [t.to(torch.int32)
           for t in random_lanes(sc.spec, 1 << 16, SEED, device)]

    def kernel():
        return megakernel.radiance_lanes(sc.data, sc.spec, *big, 0)

    times, outs = {"own": [], "slab": []}, {}
    for form in ("own", "slab", "slab", "own"):
        with (forced_slab(megakernel) if form == "slab"
              else contextlib.nullcontext()):
            times[form].append(ms_per_launch(kernel, 1, 2))
            outs[form] = kernel()
    same = all(torch.equal(a, b) for a, b in zip(outs["own"], outs["slab"]))
    slab_vs_local.append((cap, min(times["own"]), min(times["slab"])))
    del outs
    # what its paths need, on 512 of its warps, 64 warps at a time (the
    # walk holds a depth's live nodes, some 1,400 a lane at the last)
    sampled = [warp_sample(t) for t in big]
    parts = [count_work(sc.data, sc.spec, [t[i:i + 2048] for t in sampled], 0)
             for i in range(0, sampled[0].shape[0], 2048)]
    work = {k: sum(p[k] for p in parts) / len(parts)
            for k in ("visits", "warp_visits", "misses", "hits",
                      "last_hits", "chunks")}
    work["most"] = max(p["most"] for p in parts)
    b = render_bound(sc.spec, 1 << 16, work)
    print(f"    16-sample sphere over the mirror floor at max_depth 4 (stack "
          f"{cap}, instance {megakernel.tree_instance(cap)}), 65,536 random "
          f"lanes: own {[round(x, 4) for x in times['own']]} ms, slab "
          f"{[round(x, 4) for x in times['slab']]} ms, equal to the bit: "
          f"{same}; needs {work['visits']:.3f} live nodes per lane, "
          f"{work['warp_visits']:.3f} the largest of a warp, {work['most']} "
          f"the most of a lane; bound {b[0]:.4f} ms ({b[1]}); on {smi}")
    if not same:
        raise AssertionError("the slab and the local stack differ")
    print(f"    local stack against the slab, (stack, local ms, slab ms): "
          f"{slab_vs_local}; on {smi}")
    # the CLI at the fixed max_depth 4, one scene per instance
    for samples in DEEP_CLI_SPHERE + DEEP_CLI_FLOOR:
        on_floor = samples in DEEP_CLI_FLOOR
        text = (INDIRECT_FLOOR.replace("SAMPLES", str(samples)) if on_floor
                else INDIRECT4.replace("samples: 4", f"samples: {samples}"))
        path = os.path.join(sky_tmp.name, f"deep_cli_{samples}.txt")
        with open(path, "w") as f:
            f.write(text)
        sc = load_scene_file(path, device=device)
        cap = tree_loop_stack(sc.spec)[3]
        row = deep_rows[megakernel.tree_instance(cap)]
        # thousands of live nodes a lane over the mirror floor: a small image
        w, h, spp = DEEP_CLI_IMAGE
        spec_cli = dataclasses.replace(sc.spec, width=w, height=h)
        done, wall, launches, size = cli_render(
            cli, megakernel, k_tree, path,
            ["--width", str(w), "--height", str(h), "--spp", str(spp)],
            spec_cli)
        deep_launches[row] = launches[k_tree]
        print(f"    CLI, "
              + (f"a {samples}-sample IndirectPhong floor under a matte "
                 f"Phong sphere" if on_floor else
                 f"a {samples}-sample IndirectPhong sphere over a mirror "
                 f"Phong floor")
              + f" at max_depth 4 (stack {cap}, {row}): "
              f"{w}x{h} x {spp} spp: "
              f"{wall:.2f} s wall, {done['seconds']} s render "
              f"({done['seconds_profiled']} s under the profiler, the device "
              f"busy {done['device_busy']:.3f} of that), launches {launches}, "
              f"mean radiance {done['mean_radiance']:.6f}, BMP {size} B, "
              f"on {smi}")
    sky_tmp.cleanup()

    if set(deep_launches) != set(deep_rows.values()):
        raise AssertionError("the CLI did not render through every deep "
                             "instance")

    # ---- phase 22: the benchmark harness and the entry points ----
    t22 = time.perf_counter()
    print(f"[22, {at()}] the port's bench (raytrace_tpu_torch/bench.py) in "
          f"this process, each mode's line on its own; entry()'s forward; "
          f"dryrun_multichip on the two ranks of phase 20:")
    from raytrace_tpu_torch import bench
    from raytrace_tpu_torch import entry as entrylib
    torch.cuda.empty_cache()
    bench_lines = {}
    for label, argv in BENCH_RUNS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = bench.main(argv)
        lines = out.getvalue().strip().splitlines()
        print(f"    bench {' '.join(argv) or '(the default mode)'}, "
              f"{time.perf_counter() - t0:.1f} s:")
        print(lines[-1] if lines else "")
        if rc != 0 or len(lines) != 1:
            raise AssertionError(f"the bench {argv} exited {rc}: {lines}")
        line = json.loads(lines[0])
        bench_lines[label] = line
        times = [v for k, v in line.items() if k.endswith("launch_ms")]
        if not (line["value"] > 0 and all(0 < t < math.inf for t in times)):
            raise AssertionError(f"the bench's {label} line: {line}")
    for label in ("large linear", "large mixed"):
        if not bench_lines[label]["metric"].startswith(
                "large_scene_fused_vs_split_1006obj_"):
            raise AssertionError(f"not the 1,006-object field: "
                                 f"{bench_lines[label]['metric']}")
    if bench_lines["shard, one rank"]["n_devices"] != 1:
        raise AssertionError("--shard without a process group is one rank")
    d, wrapper_ms = bench_lines["default"], timing[k_lin][0]
    ratio = d["per_launch_ms"] / wrapper_ms
    print(f"    the default mode's per_launch_ms {d['per_launch_ms']:.4f} "
          f"against phase 5's wrapper call {wrapper_ms:.4f} ms: {ratio:.3f}x "
          f"(0.9-1.6x allowed); the device busy {d['device_busy']:.3f} of a "
          f"chain of {bench.BUSY_K}; {d['value']:.4g} rays/s on {smi}")
    if not BENCH_RATIO[0] <= ratio <= BENCH_RATIO[1]:
        raise AssertionError(f"the bench's launch is {ratio:.3f}x the "
                             f"wrapper call's")
    # entry()'s forward on the card (K1, one launch a call) against its
    # plain version: on every pixel of its 64x64 image (8,192 lanes) under
    # the K1 rule, and on its own example arguments (128 pixels, 256 lanes)
    # under the rule's part for lanes: there one forked lane, within the
    # lanes' budget, moves a channel's mean by some 2e-3
    fwd, eargs = entrylib.entry(device=device)
    spec_e = entrylib.golden_scene(device).spec
    pix = torch.arange(spec_e.width * spec_e.height, dtype=torch.int64,
                       device=device)
    image_args = (eargs[0], pix % spec_e.width, pix // spec_e.width,
                  eargs[3])
    for label, fargs in (("every pixel of its 64x64 image", image_args),
                         ("its example arguments", eargs)):
        before = dict(megakernel.LAUNCHES)
        got = fwd(*fargs)
        torch.cuda.synchronize()
        rose = {k: megakernel.LAUNCHES[k] - before[k]
                for k in megakernel.KERNELS}
        if rose != {k: int(k == k_lin) for k in megakernel.KERNELS}:
            raise AssertionError(f"entry()'s forward launched {rose}")
        want = sample_pixels(fargs[0], spec_e, *fargs[1:], 0,
                             radiance=megakernel.radiance_lanes_reference)
        whole = fargs is image_args
        print(f"    entry()'s forward on {label}: {tuple(got.shape)}, mean "
              f"{float(got.mean()):.6f}, one {k_lin} launch, vs its plain "
              f"version, pixel means of 2 samples, "
              + ("the K1 rule:" if whole else "the rule's part for lanes:"))
        compare(got.T, want.T, means=whole)
    # dryrun_multichip(2), run by each rank of phase 20: a step, Adam, a
    # sharded render; held to one process's loss and image here
    sc = entrylib.golden_scene(device, width=8, height=RANKS)
    pix = torch.arange(8 * RANKS, dtype=torch.int64, device=device)
    loss0, _ = optim.loss_and_grad(
        sc.data, sc.spec, pix % 8, pix // 8,
        torch.arange(2, dtype=torch.int64, device=device), 0,
        torch.zeros((8 * RANKS, 3), device=device))
    img0 = render_image(sc, seed=0, spp=2)
    for r in ranks:
        dry = r["dryrun"]
        rel = abs(dry["loss"] - float(loss0)) / abs(float(loss0))
        same = bool(np.array_equal(dry["image"].numpy(), img0))
        print(f"    rank {r['rank']}: dryrun_multichip({RANKS}) mesh "
              f"{dry['mesh']}, loss {dry['loss']:.6f} against one process's "
              f"{float(loss0):.6f} (relative {rel:.2e}), Adam moved the scene "
              f"by up to {dry['moved']:.3e}, its sharded render equal to one "
              f"process's to the bit: {same}")
        if not (dry["mesh"] == {"d": RANKS} and rel <= STEP_RTOL and same
                and dry["moved"] > 0):
            raise AssertionError(f"rank {r['rank']}: dryrun_multichip")
    print(f"    phase 22 took {time.perf_counter() - t22:.1f} s")
    # K5's and ring_rows' launches on each path that runs them: the CLI
    # with --shard-objects, and the ring's gradient forwards at k = 1 and
    # on rank 0 at k = 2, each held to its own count above; the row's
    # launches are their sum
    by_path = {row: {"shard_objects": ring_launches["linear"][k],
                     **{p: c[k] for p, c in grad_launches.items()}}
               for row, k in ((k_scan, k_scan), (k_ring_rows, "ring_rows"))}
    launches = {k_lin: lin_launches, k_tree: tree_launches,
                k_scan: sum(by_path[k_scan].values()),
                k_sky: sky_entry_launches,
                **large_launches, **sky_launches, **deep_launches,
                k_ring_start: ring_launches["linear"]["ring_start"],
                k_ring_rows: sum(by_path[k_ring_rows].values()),
                k_ring_shadow: ring_launches["lit"]["ring_shadow"],
                k_ring_lin: ring_launches["linear"]["ring_finish"],
                k_ring_tree: ring_launches["mixed"]["ring_finish"]}
    # the pallas_call of the render kernel, in its linear regime, its
    # fan-out regimes (radiance_tree_v traced in _kernel, :424, and
    # _tree_loop_scratch, :509) and its large regimes (the in-kernel table
    # fold), the pallas_call of the scan kernel, and the render kernel's
    # skybox regime (its miss records, :458-489, and the post-pass that
    # looks them up, :794-821); where the ring holds the scene the ring's
    # kernels replace the render kernel's regimes: its primary rays, shadow
    # rays and node bodies, and the winner's row that its large regime's
    # fold reads
    fold = "raytrace_tpu/ops/intersect_inline.py:100"
    call = "raytrace_tpu/render/megakernel.py:773"
    replaces = {k_lin: call, k_tree: call,
                k_lin_large: fold, k_tree_large: fold,
                k_scan: "raytrace_tpu/ops/intersect_pallas.py:302",
                k_sky: call, k_lin_sky: call, k_tree_sky: call,
                k_tree_128: call, k_tree_256: call, k_tree_slab: call,
                k_ring_start: call, k_ring_rows: fold, k_ring_shadow: call,
                k_ring_lin: call, k_ring_tree: call}
    # what launched each row's count: the scan kernel's and the ring
    # kernels', the CLI with --shard-objects (the ring) on the 1,006-object
    # linear field (K5, ring_start, ring_rows, the linear ring_finish) and
    # mixed field (the tree's ring_finish), and render_image_ring on the
    # lit mirror scene (ring_shadow); the skybox kernel's, its entry point
    # background_color on the cornell sky launch's primary directions (the
    # skybox lookup's launches on the CLI's paths are those of the (sky)
    # rows, whose kernels call it inline, as the ring's do)
    shard = "the CLI with --shard-objects (render_image_ring)"
    # and the forwards of the ring's gradients (make_ring_intersector,
    # ring_closest_hit) at k = 1 and on rank 0 at k = 2
    grads = (", and the ring's gradient forwards at k = 1 and on rank 0 at "
             "k = 2")
    direct = {k_scan: shard + grads, k_ring_start: shard,
              k_ring_rows: shard + grads,
              k_ring_shadow: "render_image_ring on the lit mirror scene",
              k_ring_lin: shard, k_ring_tree: shard,
              k_sky: "backgrounds.background_color on CUDA tensors"}
    for k in rows:
        if launches[k] < 1:
            raise AssertionError(f"{k} was launched no time by "
                                 f"{direct.get(k, 'the CLI')}")
    print(f"[all phases passed, {at()}]")
    print(json.dumps({"kernels": [{
        "name": k, "route": "cuda", "source": srcs[k.split(" ")[0]],
        "replaces": replaces[k], "launched_by": direct.get(k, "the CLI"),
        "launches": launches[k], "max_abs_err": max_err[k],
        "ms": timing[k][0], "plain_ms": timing[k][1],
        "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
        "library_ms": library_ms.get(k),
        **({"bare_ms": bare_ms[k]} if k in bare_ms else {}),
        **({"launches_by_path": by_path[k]} if k in by_path else {})}
        for k in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        sys.exit(rank_worker(sys.argv[2]))
    sys.exit(main())
