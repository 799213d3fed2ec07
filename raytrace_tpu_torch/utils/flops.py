"""Operation and byte counts of the port's kernels, and the bounds made
from them: the least time the card could take for a launch's work.

PyTorch counterpart of ``tools/flops.py``, which counts the operations of
the JAX package's traced programs.  Here the counts are made by hand from
the device functions of ``csrc/render_common.cuh``, per object test, per
table row and per part of a lane's path, and a launch's work
(``render/work.py::path_work``: live nodes, hits, misses, chunks entered)
multiplies them.  The chunks entered are counted in scene order (the JAX
package's table), not in the compact chunks that the kernels fold
(``path_work``'s ``fold_chunks``), so a bound stays the work that the
scene-order fold needs.  The peaks are the card's published ones
(:func:`raytrace_tpu_torch.utils.gpu_info.peaks`); every function takes
them and defaults to the H100 SXM's.  ``chip_smoke.py`` prints these
bounds beside the kernels' times; nothing on the render path calls this
module.
"""

from __future__ import annotations

import numpy as np

from raytrace_tpu_torch.utils.gpu_info import H100_SXM, Peaks

# FP32 operations of one object test, counted from the device functions of
# csrc/render_common.cuh: every add, subtract, multiply, compare, min or
# max, division and square root counts one; a negation, an absolute value
# and a select count nothing.  sphere_t, a small scene's sphere: 3 (o - c)
# + 6 (b) + 7 (cc, with r * r) + 4 (disc, with 4 * a) + 1 (disc > 0) + 1
# (sqrt) + 4 (t1, t2) + 2 (t1 > 0, t > 0) = 28.  sphere_row_t, a table row
# of a large scene, whose r * r the table holds and whose 4 * a the ray
# holds: 3 (o - c) + 6 (b) + 6 (cc) + 3 (disc) + 1 (disc > 0) = 19; the
# square root, the roots and their two compares lie behind the branch, run
# only on the rows whose disc is positive, and are left out.  plane_t: 5
# (denom) + 6 (numer) + 1 (denom != 0) + 1 (division) + 1 (t > 0) = 14.
# A chunk's bounding-sphere test, chunk_bound: 3 (o - c) + 6 (b) + 7 (cc)
# + 4 (disc) + 2 (pos) + 2 (max, sqrt) + 3 (margin) + 2 (t_enter) + 3 (exit
# test), and chunk_may_enter, 2, counted once per chunk = 34.  Only these
# tests are counted: a node's own arithmetic (hit record, gates, lights,
# child ray) and its shadow rays are not, so every bound made from these is
# a lower one.
FLOPS_SPHERE, FLOPS_SPHERE_ROW, FLOPS_PLANE, FLOPS_BOUND = 28, 19, 14, 34
# a skybox lookup: four texels of three floats; about 40 operations (three
# absolute values and six compares for the face, two divisions, the scaling,
# clamps and floors of u and v, nine blends of two products and a sum)
SKY_TEXEL_BYTES, FLOPS_SKY = 48, 40

# The linear kernel (K1), recounted: every operation a lane needs, by the
# unit that runs it.  Per SM and clock on compute capability 9.0 (the CUDA
# C++ Programming Guide's table of arithmetic instruction throughput): 128
# FP32 adds, multiplies or fused multiply-adds; 16 special-function
# operations (reciprocal, square root, reciprocal square root, sine, cosine,
# and the logarithm and exponential of powf); 64 32-bit integer adds,
# multiplies, shifts or logical operations.  At the H100 SXM's 1,980 MHz
# boost clock on 132 SMs the first is its FP32 peak (a fused multiply-add
# counting two operations), the others gpu_info.Peaks.sfu_ops and int_ops.
# (FP32, special-function, integer) operations of each part, counted from
# csrc/render_common.cuh as FLOPS_* are (a division, a square root, a sine
# counts one special-function operation; mix32 counts 8 integer ones:
# three shifts, three exclusive ors, two multiplies).  The keys: two seed
# words, each two xors, four absorptions of two adds and six mix32.  A
# draw: an add, two mix32, an xor and a shift, then a conversion and a
# scaling.  The primary ray: the pixel's position (8), the camera matrix
# (12), the normalization (8 and a reciprocal square root).  Depth of
# field: two draws, the focal point (6), the lens point (a square root, a
# sine and a cosine, 3) and the new origin and direction (15 and 6).  Per
# node, closest hit: the ray's a, 4a and 0.5 / a; each sphere 19 and its
# compare with the running minimum (the roots run where disc > 0 only and
# are left out, as in FLOPS_SPHERE_ROW); each plane FLOPS_PLANE and its
# compare, its division among the special-function operations.  A hit
# node, at the cheaper of its two shadings, a plane's: the hit point (6),
# n.n (5), the distance (7 and a division), the snap (6), n.d (5), the
# gates (5), the emission and the sum (6).  A node at the last depth that
# hits adds its ambient color (6); one that misses the background (6).  A
# child: indirect, two draws, the direction (11, a sine, a cosine), its
# test against the normal (6), the weight (7 and a division), the origin
# (6), weights and throughput (6); reflect, the direction (12), the origin
# (6), significance, weights and throughput (8); each then its stream (two
# mix32 and three operations).  A light, per shaded node: its direction
# (12 and two special-function operations for a point light), the shadow
# ray's origin and a (13 and a division), Lambert (16) and Phong (29, a
# reciprocal square root and powf's two); its shadow tests are not
# counted, so the bound stays a lower one.
K1_KEYS = (0, 0, 2 * (2 + 4 * 2 + 6 * 8))
K1_DRAW = (2, 0, 19)
K1_PRIMARY = (28, 1, 0)
K1_DOF = (27, 3, 0)
K1_RAY = (7, 1, 0)
K1_SPHERE, K1_PLANE = (20, 0, 0), (14, 1, 0)
K1_HIT, K1_LAST, K1_MISS = (40, 1, 0), (6, 0, 0), (6, 0, 0)
K1_INDIRECT, K1_REFLECT, K1_STREAM = (37, 3, 0), (26, 0, 0), (0, 0, 19)
K1_LIGHT = (70, 6, 0)


def k1_primary_ops(spec) -> np.ndarray:
    """(FP32, special-function, integer) operations of a lane's primary
    ray: its keys, the jitter's two draws, the ray, and for the
    depth-of-field camera the lens sample and its two draws."""
    from raytrace_tpu_torch.scene.schema import CAM_DEPTH_OF_FIELD

    v = np.array
    return (v(K1_KEYS) + 2 * v(K1_DRAW) + v(K1_PRIMARY)
            + (v(K1_DOF) + 2 * v(K1_DRAW)
               if spec.cam_type == CAM_DEPTH_OF_FIELD else 0))


def k1_lane_ops(spec, work) -> np.ndarray:
    """(FP32, special-function, integer) operations per lane of the linear
    kernel on a small scene, for lanes whose paths need ``work``
    (``render.work.path_work``)."""
    live = spec.live_objects()
    n_sph = sum(spec.shape_type[i] == 0 for i in live)
    v = np.array
    ops = k1_primary_ops(spec)
    shaded = work["hits"] - work["last_hits"]
    child = v(K1_INDIRECT) + 2 * v(K1_DRAW) if spec.n_indirect else v(K1_REFLECT)
    ops = ops + work["visits"] * (v(K1_RAY) + n_sph * v(K1_SPHERE)
                                  + (len(live) - n_sph) * v(K1_PLANE))
    ops = ops + shaded * (v(K1_HIT) + spec.n_lights * v(K1_LIGHT))
    ops = ops + work["last_hits"] * v(K1_LAST)
    ops = ops + (work["visits"] - work["hits"]) * v(K1_MISS)
    # every node but the first is some node's child
    return ops + (work["visits"] - 1) * (child + v(K1_STREAM))


def unit_bound(ops, nbytes: float, peaks: Peaks = H100_SXM):
    """(ms, "operations" or "bytes", per-unit ms) of (FP32,
    special-function, integer) operations ``ops`` and ``nbytes`` moved:
    each over its unit's peak, the bytes over the memory rate; the
    largest."""
    fp, sfu, ints = ops
    units = {"fp32": fp / peaks.fp32_flops * 1e3,
             "sfu": sfu / peaks.sfu_ops * 1e3,
             "int32": ints / peaks.int_ops * 1e3,
             "bytes": nbytes / peaks.mem_bytes * 1e3}
    worst = max(units, key=units.get)
    return (units[worst], "bytes" if worst == "bytes" else "operations",
            units)


def k1_bound(spec, n_lanes: int, work: dict, peaks: Peaks = H100_SXM):
    """(ms, "operations" or "bytes", per-unit ms) of one launch of the
    linear kernel: the lanes' operations over each unit's peak, and 28 B a
    lane and the scene once over the memory rate; the largest."""
    nbytes = (28 + SKY_TEXEL_BYTES * work["misses"]) * n_lanes + 96 * len(
        spec.live_objects())
    return unit_bound(k1_lane_ops(spec, work) * n_lanes, nbytes, peaks)


# bytes of a ring lane's fresh state (render/ring_shade.py::RingLanes):
# the node's 13 words, the sum's 3 floats, the live flag, the stack pointer
RING_STATE_BYTES = 4 * (13 + 3 + 1 + 1)


def ring_start_bound(spec, n_lanes: int, id_bytes: int = 4,
                     peaks: Peaks = H100_SXM):
    """(ms, "operations" or "bytes", per-unit ms) of one ring_start launch
    (csrc/ring_shade.cu): each lane's primary ray (:func:`k1_primary_ops`)
    over each unit's peak, and its four ids at ``id_bytes`` each in and its
    state out (:data:`RING_STATE_BYTES`; 88 B a lane with int32 ids) over
    the memory rate, the scene's header once; the largest."""
    nbytes = ((4 * id_bytes + RING_STATE_BYTES) * n_lanes
              + 4 * (24 + 16 * spec.n_lights))
    return unit_bound(k1_primary_ops(spec) * n_lanes, nbytes, peaks)


def bound(flops: float, nbytes: float, peaks: Peaks = H100_SXM):
    """(the least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    FP32 peak."""
    by_ops = flops / peaks.fp32_flops * 1e3
    by_bytes = nbytes / peaks.mem_bytes * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def render_counts(spec, n_lanes: int, work: dict, tables=None):
    """(FP32 operations, bytes) of one render-kernel launch of ``n_lanes``
    lanes whose paths need ``work`` (``raytrace_tpu_torch.render.work.
    path_work``, counted on whole warps drawn from the launch): 16 B in
    and 12 B out per lane plus the scene once, and 48 B of texels per
    skybox lookup; per live node its closest-hit tests and nothing else of
    it: every live object of a small scene, or the rows of the chunks
    entered, every chunk's bound test and the plane rows of a large one."""
    n_sph = sum(t == 0 for t in spec.shape_type)
    n_pln = sum(t == 1 for t in spec.shape_type)
    nbytes = (28 + SKY_TEXEL_BYTES * work["misses"]) * n_lanes + 96 * (
        n_sph + n_pln)
    if tables is None:
        flops = work["visits"] * (n_sph * FLOPS_SPHERE + n_pln * FLOPS_PLANE)
    else:
        n_sph_chunks = tables.n_sph_pad // 32
        flops = (work["chunks"] * 32 * FLOPS_SPHERE_ROW
                 + work["visits"] * (n_sph_chunks * FLOPS_BOUND
                                     + n_pln * FLOPS_PLANE))
        nbytes += 20 * tables.table.shape[0]
    return flops * n_lanes, nbytes


def render_bound(spec, n_lanes: int, work: dict, tables=None,
                 peaks: Peaks = H100_SXM):
    """The bound of one render-kernel launch (:func:`render_counts`)."""
    return bound(*render_counts(spec, n_lanes, work, tables), peaks)


def scan_counts(n_rays: int, entered: float, n_sph_chunks: int,
                n_planes: int, n_rows: int):
    """(FP32 operations, bytes) of one launch of the scan kernel on
    ``n_rays`` rays that enter ``entered`` sphere chunks each: the rows of
    those chunks, every chunk's bound test and every plane row per ray; 24
    B in and 9 B out per ray and the table's 20 B a row once."""
    return (n_rays * (entered * 32 * FLOPS_SPHERE_ROW
                      + n_sph_chunks * FLOPS_BOUND + n_planes * FLOPS_PLANE),
            33 * n_rays + 20 * n_rows)
