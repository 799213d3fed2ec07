"""What a launch of the tree kernel's small instance needs on a lit scene:
the closest-hit tests that ``counts.render_counts`` counts, and besides
them the shadow rays' tests of the scene's objects, with the H100 SXM's
least time for them (``counts.bound``).

``work`` is the lit reference's per lane (``reference/tree_lit.py::
work``): its ``shadow_spheres`` and ``shadow_planes`` are the object
tests of the shadow rays cast, each stopping at its first blocker in
scene order.  The bytes are ``render_counts``' (28 a lane and the
objects once) and each light's row of the scene once.
"""

from __future__ import annotations

from benchmark.yardstick import counts

LIGHT_BYTES = 64   # a light's row of the kernels' scene buffer


def lit_counts(spec, n_lanes: int, work: dict):
    """(FP32 operations, bytes) of one launch of ``n_lanes`` lanes."""
    flops, nbytes = counts.render_counts(spec, n_lanes, work)
    flops += n_lanes * (work["shadow_spheres"] * counts.FLOPS_SPHERE
                        + work["shadow_planes"] * counts.FLOPS_PLANE)
    return flops, nbytes + LIGHT_BYTES * spec.n_lights


def lit_bound(spec, n_lanes: int, work: dict):
    """(ms, "bytes" or "operations") of one launch."""
    return counts.bound(*lit_counts(spec, n_lanes, work))
