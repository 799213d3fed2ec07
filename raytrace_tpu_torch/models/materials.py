"""Material shading: one wavefront level at a time (raytrace.rs:30-226).

PyTorch counterpart of :mod:`raytrace_tpu.models.materials` for scenes
without lights, mirrors, Fresnel or Transparent materials: ambient
emission, the normal flipped toward the viewer, the significance gates,
the IndirectPhong Monte-Carlo child slots (raytrace.rs:99-117) and the
``depth > max_depth`` cutoff (raytrace.rs:33).  Recursion becomes child
slot emission, consumed by :mod:`raytrace_tpu_torch.render.integrator`.

The indirect slot keeps the reference's distribution: ``r1 ~ U[-1,1)``,
``phi ~ U[0,2pi)``, ``dir = ((1-r1^2)cos(phi), r1, (1-r1^2)sin(phi))``,
flipped into the normal's hemisphere, weighted
``diffuse * (n.dir) / (samples * 0.5)``, with the child's significance
passed on unattenuated.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytrace_tpu_torch.ops import rng, vec
from raytrace_tpu_torch.ops.intersect import HitRec
from raytrace_tpu_torch.ops.vec import V3, dot
from raytrace_tpu_torch.scene.schema import (MAT_FRESNEL, MAT_TRANSPARENT,
                                             SceneData, SceneSpec)

_OFFSET = 1e-5  # secondary-ray origin offset (raytrace.rs:43,62,108,211,220)


class Child(NamedTuple):
    """One child-slot emission: a masked batch of secondary rays."""

    ro: V3
    rd: V3
    sig: torch.Tensor      # significance for the child
    weight: V3             # throughput factor
    live: torch.Tensor     # bool: slot active for this lane
    slot: int              # static slot index (RNG stream derivation)


def unported_feature(spec: SceneSpec) -> str | None:
    """Why :func:`shade` cannot shade this scene yet, or None."""
    if spec.light_type:
        return "lights are not ported yet (ROADMAP item 8)"
    if spec.has_reflect:
        return "mirror reflection is not ported yet (ROADMAP item 8)"
    if spec.has_refract or any(t in (MAT_FRESNEL, MAT_TRANSPARENT)
                               for t in spec.mat_type):
        return ("Fresnel and Transparent materials are not ported yet "
                "(ROADMAP item 9)")
    return None


def shade(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, hit: HitRec,
          sig, live, k1, k2, depth: int):
    """Shade one level.  Returns ``(emit: V3, children: list[Child])``:
    the local radiance of each lane (background for miss lanes is the
    integrator's) and the child-ray slots (none past ``max_depth``)."""
    reason = unported_feature(spec)
    if reason is not None:
        raise NotImplementedError(reason)
    dtype = ro.x.dtype
    diffuse, msamples = hit.diffuse, hit.msamples

    pt = hit.pt
    nd = dot(hit.normal, rd)
    n_f = vec.where(nd > 0, -hit.normal, hit.normal)

    diff_sig = diffuse.x + diffuse.y + diffuse.z
    diffuse_gate = diff_sig * sig > spec.min_significance

    emit = hit.ambient
    if depth > spec.max_depth:
        # ambient only, no recursion (raytrace.rs:33)
        return emit, []

    children: list[Child] = []
    can_spawn = live & hit.hit
    for k in range(spec.n_indirect):
        r1 = rng.draw(k1, k2, rng.PURPOSE_INDIRECT_R1 + 2 * k,
                      dtype) * 2.0 - 1.0
        phi = rng.draw(k1, k2, rng.PURPOSE_INDIRECT_R2 + 2 * k,
                       dtype) * (2.0 * math.pi)
        s = 1.0 - r1 * r1
        d = V3(s * torch.cos(phi), r1, s * torch.sin(phi))
        d = vec.where(dot(d, n_f) >= 0, d, -d)
        fac = msamples * 0.5
        w = dot(n_f, d) / torch.where(fac > 0, fac, 1.0)
        gate = can_spawn & hit.is_indirect & diffuse_gate & (k < msamples)
        children.append(Child(
            ro=pt + d.scale(_OFFSET), rd=d,
            sig=sig,                      # unattenuated (raytrace.rs:109)
            weight=diffuse.scale(w), live=gate, slot=k))
    return emit, children
