"""What a launch's lanes need, counted by the yardstick: rays, operations
and bytes, and the least time the H100 could take for them.

Frozen copies, at commit 6033020, of ``raytrace_tpu_torch/bench.py::
ray_counts`` and of ``raytrace_tpu_torch/utils/flops.py`` (the
operation counts of an object test and of each part of a K1 lane, by
unit; ``k1_lane_ops``, ``unit_bound``, ``k1_bound``, ``bound``,
``render_counts``) with the H100 SXM's published peaks of
``utils/gpu_info.py``.  A later change to the program does not move
them; ``benchmark/tests/test_harness_yardstick.py`` pins each to its
original.  ``spec`` is anything with the attributes ``shape_type``
(0 sphere, 1 plane, -1 padding), ``n_indirect``, ``n_lights``,
``cam_type`` (1 depth of field), ``max_depth`` and ``cam_samples``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peak rates of one card, at its full power limit."""

    name: str
    fp32_flops: float
    mem_bytes: float
    boost_hz: float
    sm_count: int
    sfu_per_sm_clock: int = 16
    int_per_sm_clock: int = 64

    @property
    def sfu_ops(self) -> float:
        return self.sm_count * self.sfu_per_sm_clock * self.boost_hz

    @property
    def int_ops(self) -> float:
        return self.sm_count * self.int_per_sm_clock * self.boost_hz


# NVIDIA H100 Tensor Core GPU data sheet, SXM5, at 700 W: FP32 67 TFLOP/s,
# 80 GB HBM3 at 3.35 TB/s, 132 SMs at a 1,980 MHz boost clock
H100_SXM = Peaks(name="NVIDIA H100 SXM", fp32_flops=67e12, mem_bytes=3.35e12,
                 boost_hz=1.98e9, sm_count=132)

# FP32 operations of an object test (flops.py's comment gives the sums)
FLOPS_SPHERE, FLOPS_SPHERE_ROW, FLOPS_PLANE, FLOPS_BOUND = 28, 19, 14, 34
SKY_TEXEL_BYTES, FLOPS_SKY = 48, 40

# (FP32, special-function, integer) operations of each part of a K1 lane
K1_KEYS = (0, 0, 2 * (2 + 4 * 2 + 6 * 8))
K1_DRAW = (2, 0, 19)
K1_PRIMARY = (28, 1, 0)
K1_DOF = (27, 3, 0)
K1_RAY = (7, 1, 0)
K1_SPHERE, K1_PLANE = (20, 0, 0), (14, 1, 0)
K1_HIT, K1_LAST, K1_MISS = (40, 1, 0), (6, 0, 0), (6, 0, 0)
K1_INDIRECT, K1_REFLECT, K1_STREAM = (37, 3, 0), (26, 0, 0), (0, 0, 19)
K1_LIGHT = (70, 6, 0)
CAM_DEPTH_OF_FIELD = 1


def ray_counts(spec, n_pix: int, n_s: int, rounds: int | None = None) -> dict:
    """A launch of ``n_pix`` pixels of ``n_s`` samples: primary rays,
    closest-hit levels of a linear chain, rounds a primary ray takes
    (``rounds`` on a fan-out scene, else the levels), and the objects."""
    levels = spec.max_depth + 2
    return {"primary": n_pix * n_s * spec.cam_samples, "levels": levels,
            "rounds": rounds if rounds is not None else levels,
            "objects": sum(1 for t in spec.shape_type if t >= 0)}


def _live(spec) -> list[int]:
    return [i for i, t in enumerate(spec.shape_type) if t >= 0]


def k1_primary_ops(spec) -> np.ndarray:
    """(FP32, special-function, integer) operations of a primary ray."""
    v = np.array
    return (v(K1_KEYS) + 2 * v(K1_DRAW) + v(K1_PRIMARY)
            + (v(K1_DOF) + 2 * v(K1_DRAW)
               if spec.cam_type == CAM_DEPTH_OF_FIELD else 0))


def k1_lane_ops(spec, work) -> np.ndarray:
    """(FP32, special-function, integer) operations per lane of K1 on a
    small scene, for lanes whose paths need ``work``."""
    live = _live(spec)
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
    return ops + (work["visits"] - 1) * (child + v(K1_STREAM))


def unit_bound(ops, nbytes: float, peaks: Peaks = H100_SXM):
    """(ms, "operations" or "bytes", per-unit ms): each unit's operations
    over its peak, the bytes over the memory rate; the largest."""
    fp, sfu, ints = ops
    units = {"fp32": fp / peaks.fp32_flops * 1e3,
             "sfu": sfu / peaks.sfu_ops * 1e3,
             "int32": ints / peaks.int_ops * 1e3,
             "bytes": nbytes / peaks.mem_bytes * 1e3}
    worst = max(units, key=units.get)
    return (units[worst], "bytes" if worst == "bytes" else "operations",
            units)


def k1_bound(spec, n_lanes: int, work: dict, peaks: Peaks = H100_SXM):
    """The bound of one K1 launch: its lanes' operations, 28 B a lane and
    the scene once."""
    nbytes = (28 + SKY_TEXEL_BYTES * work["misses"]) * n_lanes + 96 * len(
        _live(spec))
    return unit_bound(k1_lane_ops(spec, work) * n_lanes, nbytes, peaks)


def bound(flops: float, nbytes: float, peaks: Peaks = H100_SXM):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the FP32 peak."""
    by_ops = flops / peaks.fp32_flops * 1e3
    by_bytes = nbytes / peaks.mem_bytes * 1e3
    return ((by_ops, "operations") if by_ops >= by_bytes
            else (by_bytes, "bytes"))


def padded(k: int) -> int:
    """Rows of a partition of ``k`` objects in the large scenes' table:
    whole chunks of 32, and one chunk for an empty partition."""
    return k + (-k) % 32 if k else 32


def render_counts(spec, n_lanes: int, work: dict, large: bool = False):
    """(FP32 operations, bytes) of one render launch: 28 B a lane and the
    scene once; per live node every object test of a small scene, or for
    a ``large`` one (its table: spheres, then planes, each in chunks of
    32 rows of 20 B) the rows of the chunks entered, every sphere chunk's
    bound test and the plane rows."""
    n_sph = sum(t == 0 for t in spec.shape_type)
    n_pln = sum(t == 1 for t in spec.shape_type)
    nbytes = (28 + SKY_TEXEL_BYTES * work["misses"]) * n_lanes + 96 * (
        n_sph + n_pln)
    if not large:
        flops = work["visits"] * (n_sph * FLOPS_SPHERE + n_pln * FLOPS_PLANE)
    else:
        flops = (work["chunks"] * 32 * FLOPS_SPHERE_ROW
                 + work["visits"] * (padded(n_sph) // 32 * FLOPS_BOUND
                                     + n_pln * FLOPS_PLANE))
        nbytes += 20 * (padded(n_sph) + padded(n_pln))
    return flops * n_lanes, nbytes
