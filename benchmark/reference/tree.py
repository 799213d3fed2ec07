"""The reference of fan-out scenes without lights, under the interface that
:mod:`benchmark.manifest` resolves a configuration's reference to.

Plain PyTorch over (N, 3) tensors, written from the semantics that the
port states in ``raytrace_tpu_torch/models/materials.py:1-37`` with
j-dong/rust-raytrace's citations, and from the port's counter-based
random streams (:mod:`benchmark.reference.rng`), which fix every
sample.  A primary ray per (pixel, antialias sample)
(:func:`benchmark.reference.render.primary`); a ray that hits adds its
ambient colour times its throughput, one that misses the background's;
a hit at depth ``d <= max_depth`` (raytrace.rs:33) fires its child
slots, numbered as the port numbers them, reflect, then refract, then
the indirect ones, each keying its stream by its slot:

- the normal turned toward the viewer (raytrace.rs:38,77,130,176);
- Schlick's ``clamp1(r0 + (1-r0)(1-cos)^5)`` (raytrace.rs:132-136,
  187-192), with ``1-|n.d|`` on a Fresnel material and, on a
  Transparent one leaving the body, the refracted ray's cosine;
- Snell's refraction, ``ior`` leaving and ``1/ior`` entering, and total
  internal reflection where ``sin^2 >= 1`` (raytrace.rs:177-186), the
  refracted direction normalized (raytrace.rs:219);
- the mirror ``d - 2(d.n)n``, not normalized (raytrace.rs:60-61), on
  every material but IndirectPhong, weighted by the specular colour
  (times the Fresnel factor on Fresnel and Transparent materials);
- an IndirectPhong hit's ``samples`` cosine slots, ``r1 ~ U[-1,1)``,
  ``phi ~ U[0,2pi)``, ``((1-r1^2)cos phi, r1, (1-r1^2)sin phi)`` turned
  into the normal's hemisphere and weighted
  ``diffuse (n.dir) / (samples 0.5)``, the significance passed on
  (raytrace.rs:99-117);
- the significance gates at 1/512 (raytrace.rs:35-36,74-75,137-138,193);
- every child's origin 1e-5 along its direction.

The walk visits the live nodes alone, level by level, each level's in
one compacted batch (a dead child is never made), and a lane's
contributions are added in the order of the port's depth-first walk, so
that a lane's sum rounds as the port's does.  It imports nothing of the
port and runs in any float dtype: the control runs it one precision
below the configuration's.

Departures from the description: none in what the scenes it reads can
show; :mod:`benchmark.reference.tree_scene` refuses lights, a
depth-of-field camera, a skybox, and an IndirectPhong material with a
specular part.
"""

from __future__ import annotations

import math
import types

import torch

from benchmark.reference import render, rng, tree_scene
from benchmark.reference.scene import MIN_SIGNIFICANCE, SPHERE
from benchmark.reference.tree_scene import (FRESNEL, INDIRECT, TRANSPARENT,
                                            TreeScene)
from benchmark.yardstick import counts
from benchmark.yardstick.work import chunks_entered

_dot = render._dot


def parse(text: str) -> TreeScene:
    return tree_scene.parse(text)


def leaves(scene: TreeScene, device, dtype) -> dict:
    return render.leaves(scene, device, dtype)


def nodes(scene: TreeScene) -> int:
    """Nodes of a lane's tree in the port's walk, live or not:
    ``sum_{d=0}^{max_depth+1} m^d`` for ``m`` children a node
    (:attr:`TreeScene.fan_out`)."""
    m = scene.fan_out
    return sum(m ** d for d in range(scene.max_depth + 2))


def request_rays(scene: TreeScene, width: int, height: int, spp: int) -> int:
    """Closest-hit rounds of one request: every node of every primary
    sample's tree."""
    rays = counts.ray_counts(spec(scene), width * height, spp,
                             rounds=nodes(scene))
    return rays["primary"] * rays["rounds"]


def spec(scene: TreeScene):
    """The attributes ``yardstick.counts`` reads."""
    return types.SimpleNamespace(
        shape_type=tuple(int(s) for s in scene.shape),
        n_indirect=scene.n_indirect, n_lights=0, cam_type=0,
        max_depth=scene.max_depth, cam_samples=1)


def n_objects(scene: TreeScene) -> int:
    return scene.n_objects


def _closest_hit(scene, lv, o, d, block: int):
    """:func:`render.closest_hit` in blocks of ``block`` rays."""
    parts = [render.closest_hit(scene, lv, o[i:i + block], d[i:i + block])
             for i in range(0, o.shape[0], block)]
    return tuple(torch.cat(p) for p in zip(*parts))


def _surface(scene, lv, o, d, t, obj, hit):
    """The hit point snapped onto the winner's surface and its normal, as
    :func:`render.chain` has them."""
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    pt = o + d * t_safe[:, None]
    p0, q = lv["prim_p"][obj], lv["prim_q"][obj]
    rel = pt - p0
    r2 = _dot(rel, rel)
    inv = torch.rsqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
    is_sph = torch.as_tensor(scene.shape == SPHERE, device=o.device)[obj]
    normal = render._where3(is_sph, rel * inv[:, None], q)
    on_sphere = pt - rel + rel * (q[:, 0] * inv)[:, None]
    nn = _dot(q, q)
    dist = (_dot(pt, q) - _dot(p0, q)) / torch.where(nn > 0, nn,
                                                     torch.ones_like(nn))
    on_plane = pt - q * torch.where(nn > 0, dist,
                                    torch.zeros_like(dist))[:, None]
    return render._where3(is_sph, on_sphere, on_plane), normal


def _children(scene, lv, node, obj, pt, normal):
    """The child slots of a level's hits: per slot ``(live, origin,
    direction, significance, weight)``, in the port's slot order."""
    d, sig, k1, k2 = node["d"], node["sig"], node["k1"], node["k2"]
    kind = torch.as_tensor(scene.kind, device=d.device)[obj]
    is_fresnel, is_transp = kind == FRESNEL, kind == TRANSPARENT
    is_indirect = kind == INDIRECT
    diffuse, specular = lv["mat_diffuse"][obj], lv["mat_specular"][obj]
    ior, msamples = lv["mat_ior"][obj], lv["mat_samples"][obj]
    nd = _dot(normal, d)
    n_f = render._where3(nd > 0, -normal, normal)
    # Schlick's factor and Snell's refraction (raytrace.rs:128-136, 174-192)
    r0 = (ior - 1.0) / (ior + 1.0)
    r0 = r0 * r0
    ior_safe = torch.where(ior != 0, ior, torch.ones_like(ior))
    n_ratio = torch.where(nd > 0, ior, 1.0 / ior_safe)
    sin2 = n_ratio * n_ratio * (1.0 - nd * nd)
    refract_ok = (sin2 < 1.0) & (ior != 0)
    cos_t = torch.where(refract_ok, torch.sqrt(torch.clamp(torch.where(
        refract_ok, 1.0 - sin2, torch.ones_like(sin2)), min=0.0)),
        torch.zeros_like(sin2))
    n_r = torch.where(refract_ok, n_ratio, torch.zeros_like(n_ratio))
    refr = d * n_r[:, None] - n_f * (n_r * torch.abs(nd) + cos_t)[:, None]
    omcos = torch.where(is_fresnel, 1.0 - torch.abs(nd), torch.where(
        nd > 0, torch.where(refract_ok, 1.0 - _dot(n_f, refr),
                            torch.zeros_like(nd)), 1.0 - torch.abs(nd)))
    omcos2 = omcos * omcos
    schlick = torch.clamp(r0 + (1.0 - r0) * omcos2 * omcos2 * omcos, max=1.0)
    fresnel = torch.where(is_transp & ~refract_ok, torch.ones_like(schlick),
                          schlick)
    fres = torch.where(is_fresnel | is_transp, fresnel,
                       torch.ones_like(fresnel))
    # the significance gates (raytrace.rs:35-36, 74-75, 137-138, 193)
    diff_sig = diffuse[:, 0] + diffuse[:, 1] + diffuse[:, 2]
    spec_sig = specular[:, 0] + specular[:, 1] + specular[:, 2]
    diffuse_gate = (diff_sig * sig > MIN_SIGNIFICANCE) & ~is_transp
    spec_gate = spec_sig * fres * sig > MIN_SIGNIFICANCE
    out = []
    if scene.has_reflect:
        rdir = d - n_f * (2.0 * _dot(d, n_f))[:, None]
        out.append((spec_gate & ~is_indirect, rdir, sig * spec_sig * fres,
                    specular * fres[:, None]))
    if scene.has_refract:
        omf = torch.clamp(1.0 - fresnel, max=1.0)
        n2 = _dot(refr, refr)
        pos = n2 > 0
        inv = torch.where(pos, torch.rsqrt(torch.where(
            pos, n2, torch.ones_like(n2))), torch.zeros_like(n2))
        out.append((is_transp & (fresnel < 1.0) & refract_ok,
                    refr * inv[:, None], omf * sig,
                    omf[:, None].expand(-1, 3)))
    for k in range(scene.n_indirect):
        r1 = rng.uniform(k1, k2, rng.INDIRECT_R1 + 2 * k, d.dtype) * 2.0 - 1.0
        phi = rng.uniform(k1, k2, rng.INDIRECT_R2 + 2 * k, d.dtype) * (
            2.0 * math.pi)
        s = 1.0 - r1 * r1
        cd = torch.stack([s * torch.cos(phi), r1, s * torch.sin(phi)], -1)
        cd = render._where3(_dot(cd, n_f) >= 0, cd, -cd)
        fac = msamples * 0.5
        w = _dot(n_f, cd) / torch.where(fac > 0, fac, torch.ones_like(fac))
        out.append((is_indirect & diffuse_gate & (k < msamples), cd, sig,
                    diffuse * w[:, None]))
    return [(live, pt + cdir * render.OFFSET, cdir, csig, weight)
            for live, cdir, csig, weight in out]


def walk(scene: TreeScene, lv: dict, pix, piy, aa, seed: int, width: int,
         height: int, block: int = 1 << 15, count: dict | None = None):
    """Radiance (N, 3) of lanes (pixel x, pixel y, sample), their live
    nodes walked level by level, each level's closest hits in blocks of
    ``block`` rays.  ``count``, when given, gains the work of the walk:
    live nodes (``visits``), their ``hits``, the hits at the last depth
    (``last_hits``), and each level's live rays (``rays``)."""
    o, d, k1, k2 = render.primary(scene, lv, pix, piy, aa, seed, width,
                                  height)
    n, dtype, dev = o.shape[0], o.dtype, o.device
    m, levels = scene.fan_out, scene.max_depth + 2
    # nodes of a subtree rooted at each depth: a child's place in the
    # port's preorder is its parent's + 1 + its rank among the parent's
    # live children times its subtree's nodes
    below = [sum(m ** e for e in range(levels - d)) for d in range(levels)]
    node = {"lane": torch.arange(n, device=dev), "o": o, "d": d,
            "sig": torch.ones(n, dtype=dtype, device=dev),
            "tp": torch.ones((n, 3), dtype=dtype, device=dev),
            "k1": k1, "k2": k2,
            "pre": torch.zeros(n, dtype=torch.int64, device=dev)}
    parts = []           # (lane, preorder, contribution) of every node
    bg = lv["bg_color"]
    for depth in range(levels):
        if node["lane"].shape[0] == 0:
            break
        t, obj, hit = _closest_hit(scene, lv, node["o"], node["d"], block)
        local = render._where3(hit, lv["mat_ambient"][obj],
                               bg.expand(hit.shape[0], 3))
        parts.append((node["lane"], node["pre"], node["tp"] * local))
        if count is not None:
            count["visits"] += hit.shape[0]
            count["hits"] += int(hit.sum())
            if depth == levels - 1:
                count["last_hits"] += int(hit.sum())
            count["rays"].append((node["o"], node["d"]))
        if depth == levels - 1:
            break
        # only hits fire children: keep them
        node = {k: v[hit] for k, v in node.items()}
        obj, t = obj[hit], t[hit]
        pt, normal = _surface(scene, lv, node["o"], node["d"], t, obj,
                              torch.ones_like(t, dtype=torch.bool))
        rank = torch.zeros_like(node["pre"])
        nxt = []
        for slot, (live, co, cd, csig, weight) in enumerate(
                _children(scene, lv, node, obj, pt, normal)):
            c1, c2 = rng.child(node["k1"], node["k2"], slot)
            # the port routes the j-th live slot to child j where a ray has
            # more slots than children, else slot j to child j
            j = rank if scene.children_per_ray > m else slot
            nxt.append({"lane": node["lane"], "o": co, "d": cd, "sig": csig,
                        "tp": node["tp"] * weight, "k1": c1, "k2": c2,
                        "pre": node["pre"] + 1 + j * below[depth + 1],
                        "live": live})
            rank = rank + live.to(torch.int64)
        if not nxt:
            break
        node = {k: torch.cat([c[k][c["live"]] for c in nxt])
                for k in nxt[0] if k != "live"}
    return _preorder_sum(n, nodes(scene), *map(torch.cat, zip(*parts)))


def _preorder_sum(n: int, per_lane: int, lane, pre, contrib):
    """(n, 3) sums of each lane's contributions, added one node at a time
    in preorder from zero, as the port's walk adds them."""
    order = torch.argsort(lane * per_lane + pre)
    lane, contrib = lane[order], contrib[order]
    idx = torch.arange(lane.shape[0], device=lane.device)
    first = torch.ones_like(lane, dtype=torch.bool)
    first[1:] = lane[1:] != lane[:-1]
    rank = idx - torch.cummax(torch.where(first, idx, 0), 0).values
    acc = torch.zeros((n, 3), dtype=contrib.dtype, device=contrib.device)
    for r in range(int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == r
        acc[lane[at]] = acc[lane[at]] + contrib[at]
    return acc


def pixel_means(scene: TreeScene, lv: dict, pixels, spp: int, seed: int,
                width: int, height: int, lanes_per_block: int):
    """Mean radiance (P, 3), float64, of pixels ``pixels`` (flat indices,
    row 0 at the bottom) over samples 0..spp-1, in blocks of lanes."""
    out = []
    per = max(lanes_per_block // spp, 1)
    for lo in range(0, pixels.shape[0], per):
        pix = pixels[lo:lo + per]
        px = (pix % width).repeat_interleave(spp)
        py = (pix // width).repeat_interleave(spp)
        aa = torch.arange(spp, device=pix.device).repeat(pix.shape[0])
        with torch.no_grad():
            rad = walk(scene, lv, px, py, aa, seed, width, height,
                       lanes_per_block)
        out.append(rad.double().reshape(-1, spp, 3).mean(dim=1))
    return torch.cat(out)


def work(scene: TreeScene, lv: dict, lanes, seed: int, width: int,
         height: int, large: bool) -> dict:
    """Per lane of ``lanes`` = (pixel x, pixel y, sample), over the live
    nodes of the walk: ``visits``, ``hits``, ``last_hits``, ``misses`` (0:
    a solid background looks nothing up) and, for a ``large`` scene, the
    sphere chunks entered (``yardstick.work.chunks_entered``)."""
    count = {"visits": 0, "hits": 0, "last_hits": 0, "rays": []}
    chunks = 0
    with torch.no_grad():
        walk(scene, lv, *lanes, seed, width, height, count=count)
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
