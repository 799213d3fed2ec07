"""Batched closest-hit and shadow queries (shapes.rs:43-112,
scene.rs:244-250, raytrace.rs:43-50).

PyTorch counterpart of the small-scene regime of
:mod:`raytrace_tpu.ops.intersect`: a running minimum over the (at most
``LARGE_SCENE_THRESHOLD``) live objects in scene order, then one indexed
load of the winner's row from the per-object table; shadow rays ask
only whether any object is hit in range.

Semantics kept exactly:

* sphere: strict ``discriminant > 0``; near root if ``t > 0`` else the far
  root; unit outward normal;
* plane: ``t = n.(p0 - o) / n.d``, ``t <= 0`` and ``n.d == 0`` rejected;
  the normal is the stored one, raw;
* closest hit: strict ``<``, so the first minimum in scene order wins;
* miss lanes: ``obj = 0`` and the first live object's row;
* hit points are snapped onto the analytic surface.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.ops import vec
from raytrace_tpu_torch.ops.vec import V3, dot
from raytrace_tpu_torch.scene.schema import (
    MAT_FRESNEL, MAT_INDIRECT_PHONG, MAT_TRANSPARENT, SHAPE_SPHERE,
    SceneData, SceneSpec)

# above this many live objects the JAX package scans object chunks
# (ROADMAP item 10); the port has only the small regime
LARGE_SCENE_THRESHOLD = 64

# columns of object_table() (the JAX package's packed_object_table layout)
COL_P, COL_Q, COL_DIFFUSE, COL_SPECULAR, COL_AMBIENT = 0, 3, 6, 9, 12
COL_EXPONENT, COL_IOR, COL_SAMPLES = 15, 16, 17
COL_FRESNEL, COL_TRANSP, COL_INDIRECT, COL_SPHERE = 18, 19, 20, 21


class HitRec(NamedTuple):
    """Closest-hit record plus the winner's material row."""

    t: torch.Tensor         # hit distance; +inf on miss
    hit: torch.Tensor       # bool
    obj: torch.Tensor       # int64 winning object (scene-file order)
    normal: V3              # geometric normal (reference semantics)
    pt: V3                  # hit point, snapped onto the surface
    diffuse: V3
    specular: V3
    ambient: V3
    exponent: torch.Tensor
    ior: torch.Tensor
    msamples: torch.Tensor
    is_fresnel: torch.Tensor   # bool
    is_transp: torch.Tensor    # bool
    is_indirect: torch.Tensor  # bool


def object_table(data: SceneData, spec: SceneSpec) -> torch.Tensor:
    """The (O, 22) per-object row table: geometry, material and static
    type flags, in the column order named by the ``COL_*`` constants."""
    mts = np.asarray(spec.mat_type, np.int32)
    sts = np.asarray(spec.shape_type, np.int32)
    flags = np.stack([mts == MAT_FRESNEL, mts == MAT_TRANSPARENT,
                      mts == MAT_INDIRECT_PHONG, sts == SHAPE_SPHERE], 1)
    return torch.cat([
        data.prim_p, data.prim_q, data.mat_diffuse, data.mat_specular,
        data.mat_ambient, data.mat_exponent[:, None], data.mat_ior[:, None],
        data.mat_samples[:, None],
        torch.as_tensor(flags).to(device=data.device, dtype=data.dtype),
    ], dim=1)


def safe_inv2a(a):
    """``0.5 / a``, guarded for the zero directions of dead child lanes."""
    return 0.5 / torch.where(a > 0, a, 1.0)


def _object_t(data: SceneData, spec: SceneSpec, i: int, ro: V3, rd: V3,
              a, inv2a):
    """t and validity of object ``i`` for every lane."""
    if spec.shape_type[i] == SHAPE_SPHERE:
        c = V3(data.prim_p[i, 0], data.prim_p[i, 1], data.prim_p[i, 2])
        r = data.prim_q[i, 0]
        oc = ro - c
        b = 2.0 * dot(rd, oc)
        cc = dot(oc, oc) - r * r
        disc = b * b - 4.0 * a * cc
        has = disc > 0.0
        sq = torch.sqrt(torch.where(has, disc, 1.0))
        t1 = (-b - sq) * inv2a
        t2 = (-b + sq) * inv2a
        t = torch.where(t1 > 0.0, t1, t2)
        return t, has & (t > 0.0)
    n = V3(data.prim_q[i, 0], data.prim_q[i, 1], data.prim_q[i, 2])
    p_dot_n = (data.prim_p[i, 0] * data.prim_q[i, 0]
               + data.prim_p[i, 1] * data.prim_q[i, 1]
               + data.prim_p[i, 2] * data.prim_q[i, 2])
    denom = dot(rd, n)
    numer = p_dot_n - dot(ro, n)
    ok = denom != 0.0
    t = numer / torch.where(ok, denom, 1.0)
    return t, ok & (t > 0.0)


def _snapped_point(pt: V3, rel: V3, inv, is_sph, radius, nrm: V3,
                   p0: V3) -> V3:
    """Project the reconstructed hit point onto the winner's surface:
    ``rel = pt - center`` and ``inv = 1/|rel|`` on sphere lanes, the
    plane's stored normal and point on plane lanes."""
    k = radius * inv
    sph = V3(pt.x - rel.x + rel.x * k,
             pt.y - rel.y + rel.y * k,
             pt.z - rel.z + rel.z * k)
    nn = dot(nrm, nrm)
    dist = (dot(pt, nrm) - dot(p0, nrm)) / torch.where(nn > 0, nn, 1.0)
    pln = pt - nrm.scale(torch.where(nn > 0, dist, 0.0))
    return vec.where(is_sph, sph, pln)


def closest_hit(data: SceneData, spec: SceneSpec, ro: V3, rd: V3) -> HitRec:
    """Closest-hit query plus the winner's material row (scene.rs:247-249)."""
    live = spec.live_objects()
    if len(live) > LARGE_SCENE_THRESHOLD:
        raise NotImplementedError(
            f"scenes with more than {LARGE_SCENE_THRESHOLD} objects are not "
            f"ported yet (ROADMAP item 10)")
    like = ro.x
    t_best = torch.full_like(like, float("inf"))
    hit = torch.zeros(like.shape, dtype=torch.bool, device=like.device)
    obj = torch.zeros(like.shape, dtype=torch.int64, device=like.device)
    if not live:  # empty scene: every lane misses
        z = torch.zeros_like(like)
        zv = V3(z, z, z)
        return HitRec(t=t_best, hit=hit, obj=obj, normal=zv, pt=ro,
                      diffuse=zv, specular=zv, ambient=zv, exponent=z,
                      ior=z, msamples=z, is_fresnel=hit, is_transp=hit,
                      is_indirect=hit)

    a = dot(rd, rd)
    inv2a = safe_inv2a(a)
    # the row to load: the first live object's until some object wins
    row = torch.full_like(obj, live[0])
    for i in live:
        t_i, v_i = _object_t(data, spec, i, ro, rd, a, inv2a)
        t_i = torch.where(v_i, t_i, float("inf"))
        better = t_i < t_best
        t_best = torch.where(better, t_i, t_best)
        hit = hit | v_i
        obj = torch.where(better, i, obj)
        row = torch.where(better, i, row)
    rows = object_table(data, spec)[row]

    def col(j):
        return rows[..., j]

    def col3(j):
        return V3(col(j), col(j + 1), col(j + 2))

    t_safe = torch.where(hit, t_best, 0.0)
    pt = ro + rd.scale(t_safe)
    rel = pt - col3(COL_P)
    nrm2 = dot(rel, rel)
    inv = torch.rsqrt(torch.where(nrm2 > 0, nrm2, 1.0))
    is_sph = col(COL_SPHERE) > 0.5
    q = col3(COL_Q)
    normal = vec.where(is_sph, rel.scale(inv), q)
    pt = _snapped_point(pt, rel, inv, is_sph, q.x, q, col3(COL_P))
    return HitRec(
        t=t_best, hit=hit, obj=obj, normal=normal, pt=pt,
        diffuse=col3(COL_DIFFUSE), specular=col3(COL_SPECULAR),
        ambient=col3(COL_AMBIENT), exponent=col(COL_EXPONENT),
        ior=col(COL_IOR), msamples=col(COL_SAMPLES),
        is_fresnel=col(COL_FRESNEL) > 0.5, is_transp=col(COL_TRANSP) > 0.5,
        is_indirect=col(COL_INDIRECT) > 0.5)


def occluded_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, sq_range,
               has_range: bool) -> torch.Tensor:
    """Shadow query (raytrace.rs:43-50): does any live object hit the ray,
    within range when the light has one (``t*t < sq_range``)?  Any-hit,
    so no running minimum is needed."""
    live = spec.live_objects()
    if len(live) > LARGE_SCENE_THRESHOLD:
        raise NotImplementedError(
            f"scenes with more than {LARGE_SCENE_THRESHOLD} objects are not "
            f"ported yet (ROADMAP item 10)")
    a = dot(rd, rd)
    inv2a = safe_inv2a(a)
    blocked = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    for i in live:
        t_i, v_i = _object_t(data, spec, i, ro, rd, a, inv2a)
        if has_range:
            v_i = v_i & (t_i * t_i < sq_range)
        blocked = blocked | v_i
    return blocked
