"""Material shading: one wavefront level at a time (raytrace.rs:30-226).

PyTorch counterpart of :mod:`raytrace_tpu.models.materials`.  Material
polymorphism is per-lane masked selects over the winner's row (the
closest-hit's ``HitRec``), and recursion becomes child-slot emission,
consumed by :mod:`raytrace_tpu_torch.render.integrator`.  Each lane
produces up to ``has_reflect + has_refract + n_indirect`` child rays,
numbered by a running slot counter in that order (the slot keys the
child's RNG stream).

Semantics kept exactly (with the reference's citations):

* the normal flipped toward the viewer (raytrace.rs:38,77,130,176);
* significance gates ``diffuse.significance()*sig > 1/512`` etc.
  (raytrace.rs:35-36,74-75,137-138,193);
* Lambertian ``diffuse*Lc*max(0,l.n)/pi`` and Blinn-like specular
  ``spec*Lc*max(0, n.normalize(l-d))^exp`` (raytrace.rs:52,55);
* shadow rays offset 1e-5 along the light direction, blocked iff some
  hit has ``t^2 < r^2`` (range-free lights: any hit) (raytrace.rs:43-50);
* Schlick fresnel ``clamp1(r0 + (1-r0)(1-cos)^5)``, the Fresnel material
  with ``1-|n.d|`` (raytrace.rs:132-136), the Transparent material with
  the refracted ray's cosine on exit (raytrace.rs:187-192);
* Snell refraction with ``n = ior`` exiting and ``1/ior`` entering,
  total internal reflection when ``sin^2 >= 1`` (raytrace.rs:177-186);
* mirror reflection ``d - 2(d.n)n``, un-normalized (raytrace.rs:60-61);
  the refracted direction normalized (raytrace.rs:219);
* the indirect slots' distribution: ``r1 ~ U[-1,1)``, ``phi ~ U[0,2pi)``,
  ``dir = ((1-r1^2)cos(phi), r1, (1-r1^2)sin(phi))``, flipped into the
  normal's hemisphere, weighted ``diffuse * (n.dir) / (samples * 0.5)``,
  the child's significance passed on unattenuated (raytrace.rs:99-117);
* every secondary ray's origin offset ``1e-5`` along its direction;
* the ``depth > max_depth`` cutoff: ambient only (raytrace.rs:33).

The JAX package's two documented divergences from the reference are
kept: the indirect specular term contributes 0 instead of the
reference's NaN, and ``normalize(ldir - d)`` is 0 when ``ldir == d``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytrace_tpu_torch.models.lights import light_dir_and_sq_range
from raytrace_tpu_torch.ops import rng, vec
from raytrace_tpu_torch.ops.intersect import HitRec, occluded_v
from raytrace_tpu_torch.ops.vec import V3, dot
from raytrace_tpu_torch.utils.profiling import SHADE, annotate
from raytrace_tpu_torch.scene.schema import (MAT_FRESNEL, MAT_TRANSPARENT,
                                             SceneData, SceneSpec)

_OFFSET = 1e-5  # secondary-ray origin offset (raytrace.rs:43,62,108,211,220)


def _clamp0(x):
    return torch.clamp(x, min=0.0)


def _clamp1(x):
    return torch.clamp(x, max=1.0)


class Child(NamedTuple):
    """One child-slot emission: a masked batch of secondary rays."""

    ro: V3
    rd: V3
    sig: torch.Tensor      # significance for the child
    weight: V3             # throughput factor
    live: torch.Tensor     # bool: slot active for this lane
    slot: int              # static slot index (RNG stream derivation)


@annotate(SHADE)
def shade(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, hit: HitRec,
          sig, live, k1, k2, depth: int, occluded=None):
    """Shade one level.  Returns ``(emit: V3, children: list[Child])``:
    the local radiance of each lane (ambient plus direct light; the
    background of miss lanes is the integrator's) and the child-ray
    slots (none past ``max_depth``).

    ``occluded(li, origin, ldir, sq_range, has_range, need)`` answers
    light ``li``'s shadow rays (``need``: the lanes whose light term can
    be nonzero, live hits with a significance gate open); by default
    :func:`raytrace_tpu_torch.ops.intersect.occluded_v` (the ring's
    shading asks the ring instead:
    :mod:`raytrace_tpu_torch.render.ring_shade`)."""
    dtype = ro.x.dtype
    diffuse, specular = hit.diffuse, hit.specular
    exponent, ior, msamples = hit.exponent, hit.ior, hit.msamples
    is_fresnel, is_transp, is_indirect = (hit.is_fresnel, hit.is_transp,
                                          hit.is_indirect)

    pt = hit.pt
    nd = dot(hit.normal, rd)
    n_f = vec.where(nd > 0, -hit.normal, hit.normal)

    # ---- fresnel and refraction (raytrace.rs:128-136, 174-192) ----
    # skipped when the scene has no Fresnel or Transparent material:
    # fres_mult is then exactly 1 on every lane (None below)
    has_ft = any(t in (MAT_FRESNEL, MAT_TRANSPARENT) for t in spec.mat_type)
    if has_ft:
        r0 = (ior - 1.0) / (ior + 1.0)
        r0 = r0 * r0
        ior_safe = torch.where(ior != 0, ior, 1.0)  # ior=0: no refraction
        n_ratio = torch.where(nd > 0, ior, 1.0 / ior_safe)
        sin2 = n_ratio * n_ratio * (1.0 - nd * nd)
        refract_ok = (sin2 < 1.0) & (ior != 0)
        # double where: total-internal-reflection lanes take the sqrt of
        # a safe 1.0, never of a negative number
        cos_t = torch.where(
            refract_ok,
            torch.sqrt(_clamp0(torch.where(refract_ok, 1.0 - sin2, 1.0))),
            0.0)
        n_r = torch.where(refract_ok, n_ratio, 0.0)
        refr = rd.scale(n_r) - n_f.scale(n_r * torch.abs(nd) + cos_t)
        omcos_transp = torch.where(
            nd > 0,
            torch.where(refract_ok, 1.0 - dot(n_f, refr), 0.0),
            1.0 - torch.abs(nd))
        omcos = torch.where(is_fresnel, 1.0 - torch.abs(nd), omcos_transp)
        omcos2 = omcos * omcos
        schlick = _clamp1(r0 + (1.0 - r0) * omcos2 * omcos2 * omcos)
        fresnel = torch.where(is_transp & ~refract_ok, 1.0, schlick)
        fres_mult = torch.where(is_fresnel | is_transp, fresnel,
                                torch.ones_like(fresnel))
    else:
        fresnel = refract_ok = refr = fres_mult = None

    def _fm(x):
        """``x * fres_mult`` with the static 1.0 left out."""
        return x if fres_mult is None else x * fres_mult

    # ---- significance gates ----
    diff_sig = diffuse.x + diffuse.y + diffuse.z
    spec_sig = specular.x + specular.y + specular.z
    ms = spec.min_significance
    diffuse_gate = diff_sig * sig > ms
    if has_ft:
        diffuse_gate = diffuse_gate & ~is_transp
    spec_gate = _fm(spec_sig) * sig > ms

    emit = hit.ambient  # Transparent's ambient is zero by construction
    if depth > spec.max_depth:
        # ambient only: no direct light, no recursion (raytrace.rs:33)
        return emit, []

    # ---- direct lighting, one light at a time ----
    shaded = live & hit.hit
    need = None if occluded is None else shaded & (diffuse_gate | spec_gate)
    for li, lt in enumerate(spec.light_type):
        ldir, sqr, has_range = light_dir_and_sq_range(data, lt, li, pt, k1,
                                                      k2, dtype)
        origin = pt + ldir.scale(_OFFSET)
        blocked = (occluded_v(data, spec, origin, ldir, sqr, has_range)
                   if occluded is None
                   else occluded(li, origin, ldir, sqr, has_range, need))
        vis = shaded & ~blocked
        lr, lg, lb = (data.light_color[li, 0], data.light_color[li, 1],
                      data.light_color[li, 2])
        lam = _clamp0(dot(ldir, n_f)) * (1.0 / math.pi)
        wd = torch.where(vis & diffuse_gate, lam, 0.0)
        emit = V3(emit.x + diffuse.x * lr * wd,
                  emit.y + diffuse.y * lg * wd,
                  emit.z + diffuse.z * lb * wd)
        half = vec.safe_normalize(ldir - rd)
        ph = torch.pow(_clamp0(dot(n_f, half)), exponent)
        ws = torch.where(vis & spec_gate, _fm(ph), 0.0)
        emit = V3(emit.x + specular.x * lr * ws,
                  emit.y + specular.y * lg * ws,
                  emit.z + specular.z * lb * ws)

    # ---- child slots, numbered reflect, refract, indirect ----
    children: list[Child] = []
    slot = 0
    can_spawn = live & hit.hit
    if spec.has_reflect:
        rdir = rd - n_f.scale(2.0 * dot(rd, n_f))
        children.append(Child(
            ro=pt + rdir.scale(_OFFSET), rd=rdir,
            sig=sig * spec_sig if fres_mult is None
            else sig * spec_sig * fres_mult,
            weight=specular if fres_mult is None
            else specular.scale(fres_mult),
            live=can_spawn & spec_gate & ~is_indirect, slot=slot))
        slot += 1
    if spec.has_refract:
        omf = _clamp1(1.0 - fresnel)
        rdir = vec.safe_normalize(refr)
        children.append(Child(
            ro=pt + rdir.scale(_OFFSET), rd=rdir, sig=omf * sig,
            weight=V3(omf, omf, omf),
            live=can_spawn & is_transp & (fresnel < 1.0) & refract_ok,
            slot=slot))
        slot += 1
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
        # a spec-only indirect child contributes NaN in the reference
        # (module docstring), so only diffuse-significant ones spawn
        children.append(Child(
            ro=pt + d.scale(_OFFSET), rd=d,
            sig=sig,                      # unattenuated (raytrace.rs:109)
            weight=diffuse.scale(w),
            live=can_spawn & is_indirect & diffuse_gate & (k < msamples),
            slot=slot))
        slot += 1
    return emit, children
