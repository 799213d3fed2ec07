"""The plain reference renderer: path tracing of IndirectPhong scenes.

Straight PyTorch over (N, 3) tensors, written from the semantics of
j-dong/rust-raytrace as the port states them (main.rs:39-55,
raytrace.rs:30-117, 261-276, shapes.rs:43-112, camera.rs:51-79) and from
the port's counter-based random streams, which fix every sample: a
primary ray per (pixel, antialias sample), ``max_depth + 2`` closest-hit
rounds, each hit adding its ambient colour times the path's throughput,
each miss the background's, and one cosine-weighted indirect child ray a
hit (``1 - r1^2``, as the reference has it, not its square root).  Hit
points are snapped onto the surface, the normal turned to face the ray.

It imports nothing of the port.  It is differentiable in every float leaf
(the fitting cell's gradients), and runs in any float dtype: the control
runs it one precision below the configuration's.  Lanes go in blocks, so
that a check of millions of lanes fits beside nothing else.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import rng
from benchmark.reference.scene import MIN_SIGNIFICANCE, SPHERE, RefScene

OFFSET = 1e-5   # secondary-ray origin offset (raytrace.rs:108)


def leaves(scene: RefScene, device, dtype, requires_grad=False) -> dict:
    """The scene's arrays as tensors of ``dtype`` on ``device``."""
    return {k: torch.as_tensor(v, dtype=dtype).to(device)
            .requires_grad_(requires_grad) for k, v in scene.arrays.items()}


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _where3(c, a, b):
    return torch.where(c[:, None], a, b)


def primary(scene: RefScene, lv: dict, pix, piy, aa, seed: int, width: int,
            height: int):
    """Jittered primary rays of lanes (pixel x, pixel y, sample):
    ``(origin, direction, k1, k2)`` (main.rs:39-53, camera.rs:77-79)."""
    dtype = lv["cam_matrix"].dtype
    cam = torch.zeros_like(pix)
    jk1, jk2 = rng.keys(seed, pix, piy, aa)
    u = rng.uniform(jk1, jk2, rng.AA_X, dtype)
    v = rng.uniform(jk1, jk2, rng.AA_Y, dtype)
    halfw, halfh = width / 2.0, height / 2.0
    scale = max(1.0 / halfw, 1.0 / halfh)
    x = ((rng.as_float(pix, dtype) + u) - halfw) * scale
    y = ((rng.as_float(piy, dtype) + v) - halfh) * scale
    k1, k2 = rng.keys(seed, pix, piy, aa, cam)
    m = lv["cam_matrix"]
    d = torch.stack([m[r, 0] * x + m[r, 1] * y + m[r, 2] for r in range(3)],
                    -1)
    d = d * torch.rsqrt(_dot(d, d))[:, None]
    o = lv["cam_position"].expand(d.shape)
    return o, d, k1, k2


def _object_t(scene: RefScene, lv: dict, o, d):
    """(N, O) distances to every object, +inf where it is not hit."""
    p, q = lv["prim_p"], lv["prim_q"]
    sph = torch.as_tensor(scene.shape == SPHERE, device=o.device)
    a = _dot(d, d)[:, None]
    inv2a = 0.5 / torch.where(a > 0, a, torch.ones_like(a))
    oc = o[:, None, :] - p[None]
    b = 2.0 * _dot(d[:, None, :], oc)
    cc = _dot(oc, oc) - q[:, 0] * q[:, 0]
    disc = b * b - 4.0 * a * cc
    has = disc > 0.0
    sq = torch.sqrt(torch.where(has, disc, torch.ones_like(disc)))
    t1 = (-b - sq) * inv2a
    t2 = (-b + sq) * inv2a
    ts = torch.where(t1 > 0.0, t1, t2)
    vs = has & (ts > 0.0)
    # plane: t = n.(p0 - o) / n.d; parallel rays and t <= 0 miss
    denom = _dot(d[:, None, :], q[None])
    numer = _dot(p, q)[None] - _dot(o[:, None, :], q[None])
    ok = denom != 0.0
    tp = numer / torch.where(ok, denom, torch.ones_like(denom))
    vp = ok & (tp > 0.0)
    t = torch.where(sph[None], ts, tp)
    valid = torch.where(sph[None], vs, vp)
    return torch.where(valid, t, torch.full_like(t, math.inf)), valid


def closest_hit(scene: RefScene, lv: dict, o, d):
    """``(t, obj, hit)``: the nearest object, the first in scene order on
    a tie (shapes.rs; scene.rs:247-249), ``t`` = +inf and ``obj`` = 0 on
    a miss."""
    t, valid = _object_t(scene, lv, o, d)
    with torch.no_grad():
        t_min = t.amin(dim=1, keepdim=True)
        obj = torch.argmax((t == t_min).to(torch.uint8), dim=1)
        hit = valid.any(dim=1)
        obj = torch.where(hit, obj, torch.zeros_like(obj))
    return t.gather(1, obj[:, None])[:, 0], obj, hit


def chain(scene: RefScene, lv: dict, pix, piy, aa, seed: int, width: int,
          height: int, count: dict | None = None):
    """Radiance (N, 3) of lanes (pixel x, pixel y, sample) of a linear
    scene.  ``count``, when given, gains the work of these paths: live
    nodes (``visits``), their hits and misses, the hits at the last depth
    (``last_hits``), and each depth's live rays (``rays``, for the
    yardstick's chunk count)."""
    o, d, k1, k2 = primary(scene, lv, pix, piy, aa, seed, width, height)
    n = o.shape[0]
    dtype = o.dtype
    live = torch.ones(n, dtype=torch.bool, device=o.device)
    tp = torch.ones((n, 3), dtype=dtype, device=o.device)
    acc = torch.zeros((n, 3), dtype=dtype, device=o.device)
    bg = lv["bg_color"].expand(n, 3)
    sph_obj = torch.as_tensor(scene.shape == SPHERE, device=o.device)
    last = scene.max_depth + 1
    for depth in range(last + 1):
        t, obj, hit = closest_hit(scene, lv, o, d)
        if count is not None:
            count["visits"] += int(live.sum())
            count["hits"] += int((live & hit).sum())
            if depth == last:
                count["last_hits"] += int((live & hit).sum())
            count.setdefault("rays", []).append((o[live].detach(),
                                                 d[live].detach()))
        local = _where3(hit, lv["mat_ambient"][obj], bg)
        acc = acc + _where3(live, tp * local, torch.zeros_like(tp))
        if depth == last:
            break
        # hit point, snapped onto the winner's surface, and its normal
        t_safe = torch.where(hit, t, torch.zeros_like(t))
        pt = o + d * t_safe[:, None]
        p0, q = lv["prim_p"][obj], lv["prim_q"][obj]
        rel = pt - p0
        r2 = _dot(rel, rel)
        inv = torch.rsqrt(torch.where(r2 > 0, r2, torch.ones_like(r2)))
        is_sph = sph_obj[obj]
        normal = _where3(is_sph, rel * inv[:, None], q)
        on_sphere = pt - rel + rel * (q[:, 0] * inv)[:, None]
        nn = _dot(q, q)
        dist = (_dot(pt, q) - _dot(p0, q)) / torch.where(nn > 0, nn,
                                                         torch.ones_like(nn))
        on_plane = pt - q * torch.where(nn > 0, dist,
                                        torch.zeros_like(dist))[:, None]
        pt = _where3(is_sph, on_sphere, on_plane)
        n_f = _where3(_dot(normal, d) > 0, -normal, normal)
        # the indirect child (raytrace.rs:99-117)
        r1 = rng.uniform(k1, k2, rng.INDIRECT_R1, dtype) * 2.0 - 1.0
        phi = rng.uniform(k1, k2, rng.INDIRECT_R2, dtype) * (2.0 * math.pi)
        s = 1.0 - r1 * r1
        cd = torch.stack([s * torch.cos(phi), r1, s * torch.sin(phi)], -1)
        cd = _where3(_dot(cd, n_f) >= 0, cd, -cd)
        diffuse, ms = lv["mat_diffuse"][obj], lv["mat_samples"][obj]
        fac = ms * 0.5
        w = _dot(n_f, cd) / torch.where(fac > 0, fac, torch.ones_like(fac))
        # the significance stays 1 down an indirect chain (raytrace.rs:109)
        gate = diffuse.sum(-1) > MIN_SIGNIFICANCE
        live = live & hit & gate & (ms > 0)
        o = pt + cd * OFFSET
        d = cd
        tp = _where3(live, tp * (diffuse * w[:, None]), torch.zeros_like(tp))
        k1, k2 = rng.child(k1, k2, 0)
    return acc


def pixel_means(scene: RefScene, lv: dict, pixels, spp: int, seed: int,
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
            rad = chain(scene, lv, px, py, aa, seed, width, height)
        out.append(rad.double().reshape(-1, spp, 3).mean(dim=1))
    return torch.cat(out)
