"""What a launch of the linear kernel's lit instance needs: every operation
of a K1 lane by unit (``counts.k1_lane_ops``, which counts each light's
shading at every shaded node), and besides them the shadow rays' object
tests at K1's own per-test counts, with the H100 SXM's least time for
them (``counts.unit_bound``).

``work`` is the lit reference's per lane (``reference/tree_lit.py::
work``), a lane being one lens sample of a primary sample: its
``shadow_spheres`` and ``shadow_planes`` are the object tests of the
shadow rays cast, each stopping at its first blocker in scene order.
The bytes are ``counts.k1_bound``'s (28 a lane, a skybox texel a miss,
96 an object once) and each light's row of the scene once.
"""

from __future__ import annotations

import numpy as np

from benchmark.yardstick import counts, lit


def k1_lit_ops(spec, work: dict) -> np.ndarray:
    """(FP32, special-function, integer) operations per lane."""
    v = np.array
    return (counts.k1_lane_ops(spec, work)
            + work["shadow_spheres"] * v(counts.K1_SPHERE)
            + work["shadow_planes"] * v(counts.K1_PLANE))


def k1_lit_bound(spec, n_lanes: int, work: dict,
                 peaks: counts.Peaks = counts.H100_SXM):
    """(ms, "operations" or "bytes", per-unit ms) of one launch of
    ``n_lanes`` lanes."""
    live = sum(1 for t in spec.shape_type if t >= 0)
    nbytes = ((28 + counts.SKY_TEXEL_BYTES * work["misses"]) * n_lanes
              + 96 * live + lit.LIGHT_BYTES * spec.n_lights)
    return counts.unit_bound(k1_lit_ops(spec, work) * n_lanes, nbytes,
                             peaks)
