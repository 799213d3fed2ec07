"""What a sample of lanes needs of the render kernels, counted on the
reference's own paths.

The arithmetic of ``raytrace_tpu_torch/render/work.py::path_work`` at
commit 6033020 (live nodes, hits, hits at the last depth and skybox
misses per lane; for a large scene the sphere chunks each live ray
enters), made over the reference renderer's walk, with frozen copies of
the large scenes' chunk rule (``ops/intersect_scan.py::_chunk_bounds``,
``_may_enter`` and the fold order of ``scan_hit_reference``: 32 spheres
a chunk in scene order, each chunk entered where the ray meets its
bounding sphere before its running best ``t``).  It counts what these
inputs need under that rule, whatever a later kernel does.
"""

from __future__ import annotations

import types

import torch

from benchmark.reference import render as ref
from benchmark.reference.scene import SPHERE, RefScene

CHUNK = 32
# a scene of more objects takes the large instances, which fold the table
# (ops/intersect.py::LARGE_SCENE_THRESHOLD at commit 6033020)
LARGE_ABOVE = 64


def ref_spec(scene: RefScene):
    """The attributes ``yardstick.counts`` reads, of a reference scene."""
    return types.SimpleNamespace(
        shape_type=tuple(int(s) for s in scene.shape), n_indirect=1,
        n_lights=0, cam_type=0, max_depth=scene.max_depth, cam_samples=1)


def chunk_bounds(spheres: torch.Tensor) -> torch.Tensor:
    """Bounding spheres (C, 4) of the (S, 4) sphere rows ``(c, r)`` in
    chunks of 32: the centroid of a chunk's members, the radius
    ``max(|c_i - C| + r_i)`` inflated by 1.0001 and 1e-4."""
    pad = (-spheres.shape[0]) % CHUNK
    sph = torch.cat([spheres, spheres.new_zeros((pad, 4))]).reshape(
        -1, CHUNK, 4)
    valid = sph[..., 3] > 0
    cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
    ctr = torch.where(valid[..., None], sph[..., :3], 0.0).sum(dim=1) / cnt
    dist = torch.sqrt(torch.sum((sph[..., :3] - ctr[:, None, :]) ** 2,
                                dim=-1)) + sph[..., 3]
    r = torch.where(valid, dist, 0.0).amax(dim=1)
    r = torch.where(r > 0, r * 1.0001 + 1e-4, 0.0)
    return torch.cat([ctr, r[:, None]], dim=1).to(torch.float32)


def _may_enter(bound, o, d, a, inv2a, t_best):
    ocx, ocy, ocz = o[:, 0] - bound[0], o[:, 1] - bound[1], o[:, 2] - bound[2]
    b = 2.0 * (d[:, 0] * ocx + d[:, 1] * ocy + d[:, 2] * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - bound[3] * bound[3]
    disc = b * b - 4.0 * a * cc
    pos = disc > -1e-5 * (b * b)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    margin = 1e-5 * torch.abs(b) * inv2a + 1e-4
    enters = pos & ((-b + sq) * inv2a > -margin)
    return enters & ((-b - sq) * inv2a <= t_best + margin)


def chunks_entered(spheres: torch.Tensor, o, d) -> torch.Tensor:
    """Sphere chunks each ray (N,) enters, folding the chunks in order
    with its running best ``t`` (spheres only: the planes come after)."""
    bounds = chunk_bounds(spheres)
    a = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
    inv2a = 0.5 / torch.where(a > 0, a, 1.0)
    t_best = torch.full_like(a, float("inf"))
    entered = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for c in range(bounds.shape[0]):
        rows = spheres[c * CHUNK:(c + 1) * CHUNK]
        oc = o[:, None, :] - rows[None, :, :3]
        b = 2.0 * (d[:, None, 0] * oc[..., 0] + d[:, None, 1] * oc[..., 1]
                   + d[:, None, 2] * oc[..., 2])
        cc = (oc[..., 0] * oc[..., 0] + oc[..., 1] * oc[..., 1]
              + oc[..., 2] * oc[..., 2] - rows[None, :, 3] * rows[None, :, 3])
        disc = b * b - 4.0 * a[:, None] * cc
        has = disc > 0.0
        sq = torch.sqrt(torch.where(has, disc, 1.0))
        t1 = (-b - sq) * inv2a[:, None]
        t2 = (-b + sq) * inv2a[:, None]
        t = torch.where(t1 > 0.0, t1, t2)
        t = torch.where(has & (t > 0.0) & (rows[None, :, 3] > 0), t,
                        float("inf"))
        may = _may_enter(bounds[c], o, d, a, inv2a, t_best)
        entered += may
        t_best = torch.where(may, torch.minimum(t_best, t.amin(dim=1)),
                             t_best)
    return entered


def path_work(scene: RefScene, lv: dict, lanes, seed: int, width: int,
              height: int, large: bool) -> dict:
    """Per lane of ``lanes`` = (pixel x, pixel y, sample): live nodes
    (``visits``), ``hits``, ``last_hits``, ``misses`` (0: a solid
    background looks nothing up) and, for a ``large`` scene, ``chunks``
    entered over its live nodes."""
    count = {"visits": 0, "hits": 0, "last_hits": 0}
    with torch.no_grad():
        ref.chain(scene, lv, *lanes, seed, width, height, count=count)
        chunks = 0
        if large:
            sph = scene.shape == SPHERE
            spheres = torch.cat([lv["prim_p"][sph], lv["prim_q"][sph, :1]],
                                dim=1)
            for o, d in count["rays"]:
                chunks += int(chunks_entered(spheres, o, d).sum())
    n = lanes[0].shape[0]
    return {"visits": count["visits"] / n, "hits": count["hits"] / n,
            "last_hits": count["last_hits"] / n, "misses": 0.0,
            "chunks": chunks / n}
