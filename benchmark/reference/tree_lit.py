"""The reference of lit fan-out scenes, under the interface that
:mod:`benchmark.manifest` resolves a configuration's reference to.

:mod:`benchmark.reference.tree`'s fan-out walk (its closest hits, hit
points, child slots and their streams, and its depth-first sum) with
what a lit scene seen through a depth-of-field camera adds, written from
the semantics that the port states in ``raytrace_tpu_torch/models/
materials.py:1-37``, ``models/lights.py:1-14`` and ``models/cameras.py``
with j-dong/rust-raytrace's citations:

- at every hit at depth ``d <= max_depth``, the direct light of each
  light added to the ambient colour in the scene's order of lights:
  Lambertian ``diffuse Lc max(0, l.n) / pi`` where the diffuse gate is
  open, and Blinn-like ``specular Lc max(0, n.normalize(l - d))^exp``
  (times the Fresnel factor on Fresnel and Transparent materials) where
  the specular gate is open (raytrace.rs:52,55);
- a light's term counts where its shadow ray, from 1e-5 along the
  light's direction, is not blocked: blocked where some object is hit
  with ``t^2 < r^2``, the squared distance to the light, and by any hit
  for a light without a range (raytrace.rs:43-50);
- a point light's direction ``unit(location - p)``; a directional
  light's ``-direction``, not normalized, without a range; an area
  light's a point light's at ``origin + side1 u + side2 v``, ``u`` and
  ``v`` drawn from the node's stream under the purposes
  ``PURPOSE_LIGHT_U/V + 2 li`` of light ``li`` (scene.rs:117-155);
- the depth-of-field camera (camera.rs:110-122): the pixel's jitter
  keyed by (x, y, sample), shared by its lens samples; the image-plane
  point ``p + d`` and the focal point ``p + d focus / im_dist`` of the
  un-normalized ``d``; a lens point at ``theta ~ U[0, 2pi)``,
  ``r = sqrt(u) aperture`` in the camera's u, v plane, drawn from the
  lane's stream, keyed by (x, y, sample, lens); the ray from the lens
  point toward the focal point, normalized.  A pixel's mean is over all
  ``samples x cam_samples`` lanes.

The port's two documented divergences from rust-raytrace stand: the
half vector of ``l == d`` is 0 (its normalization guarded), and an
IndirectPhong material has no specular part (the reader refuses one).
It imports nothing of the port and runs in any float dtype: the control
runs it one precision below the configuration's.

Departures from the description: none in what the scenes it reads can
show; :mod:`benchmark.reference.tree_lit_scene` refuses a skybox and a
``look_at`` camera.
"""

from __future__ import annotations

import math
import types

import torch

from benchmark.reference import render, rng, tree, tree_lit_scene
from benchmark.reference.scene import MIN_SIGNIFICANCE, SPHERE
from benchmark.reference.tree_lit_scene import AREA, DIRECTIONAL, LitScene
from benchmark.reference.tree_scene import FRESNEL, TRANSPARENT
from benchmark.yardstick import counts
from benchmark.yardstick.work import chunks_entered

# the port's purposes of the lens and area-light draws (ops/rng.py)
LENS_THETA, LENS_R = 2, 3
LIGHT_U, LIGHT_V = 64, 65

_dot, _where3 = render._dot, render._where3


def parse(text: str) -> LitScene:
    return tree_lit_scene.parse(text)


def leaves(scene: LitScene, device, dtype) -> dict:
    return render.leaves(scene, device, dtype)


def request_rays(scene: LitScene, width: int, height: int, spp: int) -> int:
    """Closest-hit rounds of one request: every node of every primary
    lane's tree, a lane per sample and lens sample; shadow rays are not
    counted."""
    rays = counts.ray_counts(spec(scene), width * height, spp,
                             rounds=tree.nodes(scene))
    return rays["primary"] * rays["rounds"]


def spec(scene: LitScene):
    """The attributes ``yardstick.counts`` reads."""
    return types.SimpleNamespace(
        shape_type=tuple(int(s) for s in scene.shape),
        n_indirect=scene.n_indirect, n_lights=scene.n_lights,
        cam_type=int(scene.dof), max_depth=scene.max_depth,
        cam_samples=scene.cam_samples)


def n_objects(scene: LitScene) -> int:
    return scene.n_objects


def primary(scene: LitScene, lv: dict, pix, piy, aa, cam, seed: int,
            width: int, height: int):
    """Jittered primary rays of lanes (pixel x, pixel y, sample, lens
    sample): ``(origin, direction, k1, k2)``."""
    dtype = lv["cam_matrix"].dtype
    jk1, jk2 = rng.keys(seed, pix, piy, aa)
    u = rng.uniform(jk1, jk2, rng.AA_X, dtype)
    v = rng.uniform(jk1, jk2, rng.AA_Y, dtype)
    halfw, halfh = width / 2.0, height / 2.0
    scale = max(1.0 / halfw, 1.0 / halfh)
    x = ((rng.as_float(pix, dtype) + u) - halfw) * scale
    y = ((rng.as_float(piy, dtype) + v) - halfh) * scale
    k1, k2 = rng.keys(seed, pix, piy, aa, cam)
    m, pos = lv["cam_matrix"], lv["cam_position"]

    def apply(a, b, c):
        return torch.stack([m[r, 0] * a + m[r, 1] * b + m[r, 2] * c
                            for r in range(3)], -1)

    d = apply(x, y, torch.ones_like(x))
    if scene.dof:
        fp = pos + d * (lv["cam_focus"] / lv["cam_im_dist"])
        theta = rng.uniform(k1, k2, LENS_THETA, dtype) * (2.0 * math.pi)
        r = torch.sqrt(rng.uniform(k1, k2, LENS_R, dtype)) * lv[
            "cam_aperture"]
        o = (pos + d) + apply(torch.cos(theta) * r, torch.sin(theta) * r,
                              torch.zeros_like(r))
        d = fp - o
    else:
        o = pos.expand(d.shape)
    return o, d * torch.rsqrt(_dot(d, d))[:, None], k1, k2


def _gates(scene, lv, node, obj, normal):
    """The normal turned toward the viewer, the factor on the specular
    terms (Schlick's on Fresnel and Transparent materials, else 1), and
    the diffuse and specular gates, as :func:`tree._children` has them."""
    d, sig = node["d"], node["sig"]
    kind = torch.as_tensor(scene.kind, device=d.device)[obj]
    is_fresnel, is_transp = kind == FRESNEL, kind == TRANSPARENT
    diffuse, specular = lv["mat_diffuse"][obj], lv["mat_specular"][obj]
    ior = lv["mat_ior"][obj]
    nd = _dot(normal, d)
    n_f = _where3(nd > 0, -normal, normal)
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
    diff_sig = diffuse[:, 0] + diffuse[:, 1] + diffuse[:, 2]
    spec_sig = specular[:, 0] + specular[:, 1] + specular[:, 2]
    return (n_f, fres, (diff_sig * sig > MIN_SIGNIFICANCE) & ~is_transp,
            spec_sig * fres * sig > MIN_SIGNIFICANCE)


def _to_light(lv, kind: int, li: int, pt, k1, k2):
    """Direction from ``pt`` to light ``li``, its squared range, and
    whether it has one."""
    zero = torch.zeros_like(pt)
    if kind == DIRECTIONAL:
        return zero - lv["light_e1"][li], zero[:, 0], False
    loc = lv["light_p"][li].expand(pt.shape)
    if kind == AREA:
        u = rng.uniform(k1, k2, LIGHT_U + 2 * li, pt.dtype)
        v = rng.uniform(k1, k2, LIGHT_V + 2 * li, pt.dtype)
        loc = loc + lv["light_e1"][li] * u[:, None] + lv["light_e2"][li] * \
            v[:, None]
    rel = loc - pt
    sq = _dot(rel, rel)
    inv = 1.0 / torch.sqrt(torch.where(sq > 0, sq, torch.ones_like(sq)))
    return rel * inv[:, None], sq, True


def _blockers(scene, lv, o, d, sq, has_range: bool, block: int):
    """(N, O): which objects block each shadow ray, in blocks of ``block``
    rays."""
    out = []
    for i in range(0, max(o.shape[0], 1), block):
        t, valid = render._object_t(scene, lv, o[i:i + block], d[i:i + block])
        out.append(valid & (t * t < sq[i:i + block, None]) if has_range
                   else valid)
    return torch.cat(out)


def _shadow_tests(scene, block):
    """Sphere and plane tests of shadow rays that stop at their first
    blocker in scene order, summed over the rays."""
    n_obj = block.shape[1]
    blocked = block.any(dim=1)
    tested = torch.where(blocked, torch.argmax(block.to(torch.uint8), 1) + 1,
                         n_obj)
    sph = torch.cumsum(torch.as_tensor(scene.shape == SPHERE,
                                       device=block.device), 0)
    spheres = int(sph[tested - 1].sum())
    return spheres, int(tested.sum()) - spheres


def _direct(scene, lv, node, obj, pt, normal, block: int,
            count: dict | None = None):
    """The local colour (N, 3) of a level's hits: the ambient colour plus
    each light's terms, the shadow rays tested in blocks of ``block``.
    ``count``, when given, gains the shadow rays of
    the hits whose gates let some light term through (``shadow``) and
    their sphere and plane tests."""
    d, k1, k2 = node["d"], node["k1"], node["k2"]
    n_f, fres, diffuse_gate, spec_gate = _gates(scene, lv, node, obj, normal)
    diffuse, specular = lv["mat_diffuse"][obj], lv["mat_specular"][obj]
    exponent = lv["mat_exponent"][obj]
    emit = lv["mat_ambient"][obj]
    cast = diffuse_gate | spec_gate
    for li, kind in enumerate(scene.light_kind):
        ldir, sq, has_range = _to_light(lv, kind, li, pt, k1, k2)
        blockers = _blockers(scene, lv, pt + ldir * render.OFFSET, ldir, sq,
                             has_range, block)
        if count is not None:
            count["shadow"] += int(cast.sum())
            spheres, planes = _shadow_tests(scene, blockers[cast])
            count["shadow_spheres"] += spheres
            count["shadow_planes"] += planes
        vis = ~blockers.any(dim=1)
        lc = lv["light_color"][li]
        lam = torch.clamp(_dot(ldir, n_f), min=0.0) * (1.0 / math.pi)
        wd = torch.where(vis & diffuse_gate, lam, torch.zeros_like(lam))
        emit = emit + diffuse * lc * wd[:, None]
        half = ldir - d
        h2 = _dot(half, half)
        pos = h2 > 0
        half = half * torch.where(pos, torch.rsqrt(torch.where(
            pos, h2, torch.ones_like(h2))), torch.zeros_like(h2))[:, None]
        ph = torch.pow(torch.clamp(_dot(n_f, half), min=0.0), exponent)
        ws = torch.where(vis & spec_gate, ph * fres, torch.zeros_like(ph))
        emit = emit + specular * lc * ws[:, None]
    return emit


def walk(scene: LitScene, lv: dict, pix, piy, aa, cam, seed: int,
         width: int, height: int, block: int = 1 << 15,
         count: dict | None = None):
    """Radiance (N, 3) of lanes (pixel x, pixel y, sample, lens sample),
    their live nodes walked level by level as :func:`tree.walk` walks
    them, each hit above the last level lit, the closest hits and shadow
    rays in blocks of ``block`` rays.  ``count``, when given, gains
    ``tree.walk``'s counts and the shadow rays with their tests."""
    o, d, k1, k2 = primary(scene, lv, pix, piy, aa, cam, seed, width,
                           height)
    n, dtype, dev = o.shape[0], o.dtype, o.device
    m, levels = scene.fan_out, scene.max_depth + 2
    below = [sum(m ** e for e in range(levels - d)) for d in range(levels)]
    node = {"lane": torch.arange(n, device=dev), "o": o, "d": d,
            "sig": torch.ones(n, dtype=dtype, device=dev),
            "tp": torch.ones((n, 3), dtype=dtype, device=dev),
            "k1": k1, "k2": k2,
            "pre": torch.zeros(n, dtype=torch.int64, device=dev)}
    parts = []           # (lane, preorder, contribution) of every node
    for depth in range(levels):
        if node["lane"].shape[0] == 0:
            break
        t, obj, hit = tree._closest_hit(scene, lv, node["o"], node["d"],
                                        block)
        last = depth == levels - 1
        if count is not None:
            count["visits"] += hit.shape[0]
            count["hits"] += int(hit.sum())
            if last:
                count["last_hits"] += int(hit.sum())
            count["rays"].append((node["o"], node["d"]))
        local = lv["bg_color"].expand(hit.shape[0], 3).clone()
        lanes, pre, tp = node["lane"], node["pre"], node["tp"]
        node = {k: v[hit] for k, v in node.items()}
        obj, t = obj[hit], t[hit]
        if last:
            local[hit] = lv["mat_ambient"][obj]
            parts.append((lanes, pre, tp * local))
            break
        pt, normal = tree._surface(scene, lv, node["o"], node["d"], t, obj,
                                   torch.ones_like(t, dtype=torch.bool))
        local[hit] = _direct(scene, lv, node, obj, pt, normal, block, count)
        parts.append((lanes, pre, tp * local))
        rank = torch.zeros_like(node["pre"])
        nxt = []
        for slot, (live, co, cd, csig, weight) in enumerate(
                tree._children(scene, lv, node, obj, pt, normal)):
            c1, c2 = rng.child(node["k1"], node["k2"], slot)
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
    return tree._preorder_sum(n, tree.nodes(scene),
                              *map(torch.cat, zip(*parts)))


def _with_lens(scene: LitScene, pix, piy, aa):
    """Lanes (pixel x, pixel y, sample, lens sample): each of the given
    (pixel x, pixel y, sample) with every lens sample, in that order."""
    k = scene.cam_samples
    cam = torch.arange(k, device=pix.device).repeat(pix.shape[0])
    return (*(w.repeat_interleave(k) for w in (pix, piy, aa)), cam)


def pixel_means(scene: LitScene, lv: dict, pixels, spp: int, seed: int,
                width: int, height: int, lanes_per_block: int):
    """Mean radiance (P, 3), float64, of pixels ``pixels`` (flat indices,
    row 0 at the bottom) over samples 0..spp-1 and every lens sample, in
    blocks of lanes."""
    out = []
    per_pixel = spp * scene.cam_samples
    per = max(lanes_per_block // per_pixel, 1)
    for lo in range(0, pixels.shape[0], per):
        pix = pixels[lo:lo + per]
        px = (pix % width).repeat_interleave(spp)
        py = (pix // width).repeat_interleave(spp)
        aa = torch.arange(spp, device=pix.device).repeat(pix.shape[0])
        with torch.no_grad():
            rad = walk(scene, lv, *_with_lens(scene, px, py, aa), seed,
                       width, height, lanes_per_block)
        out.append(rad.double().reshape(-1, per_pixel, 3).mean(dim=1))
    return torch.cat(out)


def work(scene: LitScene, lv: dict, lanes, seed: int, width: int,
         height: int, large: bool) -> dict:
    """Per lane of ``lanes`` = (pixel x, pixel y, sample), each taken with
    every lens sample, over the live nodes of the walk: ``visits``, ``hits``,
    ``last_hits``, ``misses`` (0: a solid background looks nothing up),
    ``shadow`` (the shadow rays cast: one a light at each hit above the
    last level whose gates let some light term through), the sphere and
    plane tests they make (``shadow_spheres``, ``shadow_planes``: an
    any-hit stops at its first blocker in scene order) and, for a
    ``large`` scene, the sphere chunks entered by the closest-hit rays
    (``yardstick.work.chunks_entered``)."""
    lanes = _with_lens(scene, *lanes)
    count = {"visits": 0, "hits": 0, "last_hits": 0, "rays": [],
             "shadow": 0, "shadow_spheres": 0, "shadow_planes": 0}
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
    out = {k: count[k] / n for k in ("visits", "hits", "last_hits", "shadow",
                                     "shadow_spheres", "shadow_planes")}
    return dict(out, misses=0.0, chunks=chunks / n)
