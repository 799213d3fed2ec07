"""Batched closest-hit and shadow queries (shapes.rs:43-112,
scene.rs:244-250, raytrace.rs:43-50).

PyTorch counterpart of :mod:`raytrace_tpu.ops.intersect`, in its two
regimes.  Up to ``LARGE_SCENE_THRESHOLD`` live objects: a running
minimum over the objects in scene order.  Above it: a scan of the
unified primitive table (:func:`_packed_tables`; spheres, then planes,
in chunks of 32 rows), by the plain PyTorch scan.  Either way the
winner's row is one indexed load from the per-object table; shadow rays
ask only whether any object is hit in range.  While a ring context is
installed (:func:`set_ring_ctx`, by an object-sharded render of
:mod:`raytrace_tpu_torch.parallel.ring`), both queries go round the
ring of object shards instead, whose steps are the CUDA scan kernel on
CUDA tensors; the scene's own object leaves are then never read.

Semantics kept exactly:

* sphere: strict ``discriminant > 0``; near root if ``t > 0`` else the far
  root; unit outward normal;
* plane: ``t = n.(p0 - o) / n.d``, ``t <= 0`` and ``n.d == 0`` rejected;
  the normal is the stored one, raw;
* closest hit: the first minimum in scene order wins (strict ``<`` in
  the small regime, the lower object id on an exact tie in the scan);
* miss lanes: ``obj = 0``, and the first live object's row in the small
  regime, object 0's row and ``ior = 1`` in the large one;
* hit points are snapped onto the analytic surface.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.ops import intersect_scan, vec
from raytrace_tpu_torch.ops.vec import V3, dot
from raytrace_tpu_torch.utils.profiling import INTERSECT, annotate
from raytrace_tpu_torch.scene.schema import (
    MAT_FRESNEL, MAT_INDIRECT_PHONG, MAT_TRANSPARENT, SHAPE_PLANE,
    SHAPE_SPHERE, SceneData, SceneSpec)

# above this many live objects the per-object loop gives way to the scan
# of the unified table, so that the work per object stays a table row
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


def hitrec_from_cols(col, t_best, obj, hit, ro: V3, rd: V3) -> HitRec:
    """The hit record of the winner's row: normal, snapped hit point and
    material fields.  ``col(j)`` is column ``j`` of the lanes' rows, in
    the layout of :func:`object_table`."""
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


def _typed_geometry(spec: SceneSpec):
    """Static type partition: (sphere indices, plane indices)."""
    st = np.asarray(spec.shape_type)
    return np.nonzero(st == SHAPE_SPHERE)[0], np.nonzero(st == SHAPE_PLANE)[0]


def _packed_tables(data: SceneData, spec: SceneSpec):
    """The unified primitive table the scan reads: spheres ``(cx, cy, cz,
    r)`` first, then planes ``(n, p.n)``, each partition zero-padded to a
    multiple of ``intersect_scan.OBJ_CHUNK`` rows (an empty partition
    still takes one chunk); pad rows carry id -1.  Returns ``(table,
    n_sph_pad, ids)`` with ``ids`` the int32 object index of each row."""
    sph, pln = _typed_geometry(spec)
    ck = intersect_scan.OBJ_CHUNK

    def pad(rows, ids):
        extra = (-len(ids)) % ck if len(ids) else ck
        rows = torch.cat([rows, rows.new_zeros((extra, 4))])
        return rows, np.concatenate([ids.astype(np.int32),
                                     np.full(extra, -1, np.int32)])

    sph_rows, sph_ids = pad(
        torch.cat([data.prim_p[sph], data.prim_q[sph, 0:1]], dim=1), sph)
    pn = torch.sum(data.prim_p[pln] * data.prim_q[pln], dim=1, keepdim=True)
    pln_rows, pln_ids = pad(torch.cat([data.prim_q[pln], pn], dim=1), pln)
    ids = torch.from_numpy(np.concatenate([sph_ids, pln_ids]))
    return (torch.cat([sph_rows, pln_rows]), sph_rows.shape[0],
            ids.to(data.device))


class SceneTables(NamedTuple):
    """What the large regime reads, on the scene's device."""

    table: torch.Tensor    # (C*32, 4) unified primitive table
    ids: torch.Tensor      # (C*32,) int32 object index per row, -1 pad
    n_sph_pad: int         # rows of the sphere partition
    bounds: torch.Tensor   # (C, 4) float32 chunk bounding spheres
    rows: torch.Tensor     # (O, 22) object_table


def per_scene_cache(fn):
    """Keep the last result of ``fn(data, spec)``: reused while the same
    scene tensors, unmodified (by their version counters), come with an
    equal spec, as they do in every launch of one render.  Scenes that
    require grad are computed anew each time."""
    last = None

    def cached(data: SceneData, spec: SceneSpec):
        nonlocal last
        leaves = tuple(getattr(data, f.name) for f in dataclasses.fields(data))
        if any(t.requires_grad for t in leaves):
            return fn(data, spec)
        versions = tuple(t._version for t in leaves)
        if (last is not None and all(a is b for a, b in zip(last[0], leaves))
                and last[1] == versions and last[2] == spec):
            return last[3]
        out = fn(data, spec)
        last = (leaves, versions, spec, out)
        return out

    cached.__doc__ = fn.__doc__
    return cached


@per_scene_cache
def scene_tables(data: SceneData, spec: SceneSpec) -> SceneTables:
    """The large regime's tables of a scene (cached per scene)."""
    table, n_sph_pad, ids = _packed_tables(data, spec)
    n_chunks = table.shape[0] // intersect_scan.OBJ_CHUNK
    bounds = intersect_scan._chunk_bounds(table, n_sph_pad, n_chunks)
    return SceneTables(table, ids, n_sph_pad, bounds,
                       object_table(data, spec))


def flat_scan(scan, ro: V3, rd: V3):
    """``(t_best, obj, hit)`` of ``scan`` (a function of (N,) rays that
    returns ``(t_best, global id, hit)``) on lanes of any shape, with
    ``obj = 0`` on miss lanes."""
    shape = ro.x.shape
    ro, rd = (V3(*(c.reshape(-1) for c in v)) for v in (ro, rd))
    t_best, gid, hit = scan(ro, rd)
    obj = torch.where(hit, gid, 0).to(torch.int64)
    return t_best.reshape(shape), obj.reshape(shape), hit.reshape(shape)


def _scan_all_objects(data: SceneData, spec: SceneSpec, ro: V3, rd: V3):
    """``(t_best, obj, hit)`` over all objects of a large scene by the
    plain scan."""
    tb = scene_tables(data, spec)
    return flat_scan(lambda o, d: intersect_scan.scan_hit_reference(
        tb.table, tb.ids, tb.n_sph_pad, o, d), ro, rd)


def large_scene_rec(rows, t_best, obj, hit, ro: V3, rd: V3) -> HitRec:
    """A large scene's hit record from the winners' rows (object 0's on a
    miss), with a finite ``ior`` of 1 on misses."""
    rec = hitrec_from_cols(lambda j: rows[..., j], t_best, obj, hit, ro, rd)
    return rec._replace(ior=torch.where(hit, rec.ior, 1.0))


def _closest_hit_scanned(data: SceneData, spec: SceneSpec, ro: V3,
                         rd: V3) -> HitRec:
    """Large-scene closest hit: the scan, then one indexed load of the
    winner's row."""
    t_best, obj, hit = _scan_all_objects(data, spec, ro, rd)
    return large_scene_rec(scene_tables(data, spec).rows[obj], t_best, obj,
                           hit, ro, rd)


# The ring context of an object-sharded render
# (raytrace_tpu_torch.parallel.ring.RingContext), or None.  While one is
# installed, closest_hit and occluded_v answer through the ring, before
# anything reads the scene's object leaves (which the ring render replaces
# with one-row dummies).
_RING_CTX = None


def set_ring_ctx(ctx):
    """Install a ring context; returns the previous one (for restore)."""
    global _RING_CTX
    prev = _RING_CTX
    _RING_CTX = ctx
    return prev


def ring_ctx():
    """The installed ring context, or None."""
    return _RING_CTX


@annotate(INTERSECT)
def closest_hit(data: SceneData, spec: SceneSpec, ro: V3, rd: V3) -> HitRec:
    """Closest-hit query plus the winner's material row (scene.rs:247-249)."""
    if _RING_CTX is not None:
        from raytrace_tpu_torch.parallel import ring
        return ring.ring_closest_hit(_RING_CTX, ro, rd)
    live = spec.live_objects()
    if len(live) > LARGE_SCENE_THRESHOLD:
        return _closest_hit_scanned(data, spec, ro, rd)
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
    return hitrec_from_cols(lambda j: rows[..., j], t_best, obj, hit, ro, rd)


def occluded_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3, sq_range,
               has_range: bool) -> torch.Tensor:
    """Shadow query (raytrace.rs:43-50): does any live object hit the ray,
    within range when the light has one (``t*t < sq_range``)?  Any-hit,
    so the small regime needs no running minimum; the large one asks the
    scan for the closest hit, which is in range iff any hit is."""
    if _RING_CTX is not None:
        from raytrace_tpu_torch.parallel import ring
        return ring.ring_occluded(_RING_CTX, ro, rd, sq_range, has_range)
    live = spec.live_objects()
    if len(live) > LARGE_SCENE_THRESHOLD:
        t_best, _, hit = _scan_all_objects(data, spec, ro, rd)
        return hit & (t_best * t_best < sq_range) if has_range else hit
    a = dot(rd, rd)
    inv2a = safe_inv2a(a)
    blocked = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    for i in live:
        t_i, v_i = _object_t(data, spec, i, ro, rd, a, inv2a)
        if has_range:
            v_i = v_i & (t_i * t_i < sq_range)
        blocked = blocked | v_i
    return blocked
