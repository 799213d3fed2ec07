"""The scene language's fan-out subset, read by the tree reference on its
own.

Beside what :mod:`benchmark.reference.scene` reads, the four materials
of j-dong/rust-raytrace (scene.rs:32-89): ``PhongMaterial``,
``IndirectPhongMaterial`` with any number of samples, ``FresnelMaterial``
and ``TransparentMaterial`` (no diffuse or ambient part).  No lights,
``SimplePerspectiveCamera new(...)`` and ``SolidColorBackground`` only;
anything else raises.  An ``IndirectPhongMaterial`` with a specular part
is refused too: rust-raytrace's indirect rays then give NaN where the
port gives 0 (``raytrace_tpu_torch/models/materials.py``'s docstring),
and the reference takes on neither.

The child slots a shaded ray may fire are the scene's, as the port
numbers them: reflect where some Phong, Fresnel or Transparent material
has a specular part, refract where some material is Transparent, then
one indirect slot per sample of the most-sampled IndirectPhong material
that has a diffuse part.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.scene import (MAX_DEPTH, PLANE, SPHERE, RefScene,
                                       _Reader, _unit)

PHONG, INDIRECT, FRESNEL, TRANSPARENT = 0, 1, 2, 3
_KINDS = {"PhongMaterial": PHONG, "IndirectPhongMaterial": INDIRECT,
          "FresnelMaterial": FRESNEL, "TransparentMaterial": TRANSPARENT}
# each material's fields, beyond which the reader refuses (serialize.rs)
_FIELDS = {
    PHONG: {"diffuse", "specular", "exponent", "ambient"},
    INDIRECT: {"diffuse", "specular", "exponent", "ambient", "samples"},
    FRESNEL: {"diffuse", "specular", "exponent", "ambient", "ior"},
    TRANSPARENT: {"specular", "exponent", "ior"},
}


@dataclasses.dataclass
class TreeScene(RefScene):
    """A :class:`RefScene` with each object's material kind and the
    scene's child slots."""

    kind: np.ndarray = None    # (O,) PHONG, INDIRECT, FRESNEL, TRANSPARENT
    has_reflect: bool = False
    has_refract: bool = False
    n_indirect: int = 0

    @property
    def children_per_ray(self) -> int:
        return int(self.has_reflect) + int(self.has_refract) + self.n_indirect

    @property
    def fan_out(self) -> int:
        """Children a node of the port's walk has: at most this many of a
        ray's slots fire at once (reflect and refract on the other
        materials, the indirect ones on IndirectPhong alone)."""
        live = max(int(self.has_reflect) + int(self.has_refract),
                   self.n_indirect)
        return max(min(live, self.children_per_ray), 1)


def parse(text: str) -> TreeScene:
    """The :class:`TreeScene` of a scene text in the subset above."""
    top = _Reader(text).value()
    if not isinstance(top, dict):
        raise ValueError("scene text: the top level is not a block")
    if top.get("lights"):
        raise ValueError("the tree reference renders scenes without lights")
    objs = top["objects"]
    n = len(objs)
    prim_p, prim_q = np.zeros((n, 3)), np.zeros((n, 3))
    diffuse, specular, ambient = (np.zeros((n, 3)) for _ in range(3))
    exponent, ior, samples = np.ones(n), np.ones(n), np.zeros(n)
    shape = np.zeros(n, np.int64)
    kind = np.zeros(n, np.int64)
    for i, o in enumerate(objs):
        bkind, b = o["bounds"]
        if bkind == "Sphere":
            shape[i] = SPHERE
            prim_p[i] = b["center"]
            prim_q[i, 0] = b["radius"]
        elif bkind == "Plane":
            shape[i] = PLANE
            prim_p[i] = b["point"]
            prim_q[i] = b["normal"]
        else:
            raise ValueError(f"the tree reference has no bounds {bkind}")
        mname, m = o["material"]
        if mname not in _KINDS:
            raise ValueError(f"the tree reference has no material {mname}")
        kind[i] = k = _KINDS[mname]
        if set(m) != _FIELDS[k]:
            raise ValueError(f"{mname} with fields {sorted(m)}")
        specular[i], exponent[i] = m["specular"], m["exponent"]
        if k != TRANSPARENT:
            diffuse[i], ambient[i] = m["diffuse"], m["ambient"]
        if k in (FRESNEL, TRANSPARENT):
            ior[i] = m["ior"]
        if k == INDIRECT:
            samples[i] = m["samples"]
            if sum(m["specular"]) != 0.0:
                raise ValueError("the tree reference's IndirectPhong has no "
                                 "specular part")
    spec_sig = specular.sum(axis=1) > 0.0
    indirect = (kind == INDIRECT) & (diffuse.sum(axis=1) > 0.0)
    cam = top["camera"]
    if cam[0] != "SimplePerspectiveCamera" or cam[1] != "new":
        raise ValueError(f"the tree reference has no camera {cam[:2]}")
    pos, look, up, im_dist = (np.asarray(a, np.float64) for a in cam[2])
    # camera.rs:51-63: columns u = look x up, v = u x look, w = look
    u = _unit(np.cross(look, up))
    v = _unit(np.cross(u, look))
    w = _unit(look) * float(im_dist)
    bkind, bg = top["background"]
    if bkind != "SolidColorBackground":
        raise ValueError(f"the tree reference has no background {bkind}")
    opts = top["options"]
    if set(opts) != {"width", "height", "antialias"}:
        raise ValueError(f"the tree reference has no options {sorted(opts)}")
    arrays = dict(
        prim_p=prim_p, prim_q=prim_q, mat_diffuse=diffuse,
        mat_specular=specular, mat_exponent=exponent, mat_ambient=ambient,
        mat_ior=ior, mat_samples=samples,
        cam_position=pos, cam_matrix=np.stack([u, v, w], axis=1),
        bg_color=np.asarray(bg["color"], np.float64))
    return TreeScene(
        arrays=arrays, shape=shape, width=int(opts["width"]),
        height=int(opts["height"]), antialias=int(opts["antialias"]),
        max_depth=MAX_DEPTH, kind=kind,
        has_reflect=bool(np.any((kind != INDIRECT) & spec_sig)),
        has_refract=bool(np.any(kind == TRANSPARENT)),
        n_indirect=int(samples[indirect].max(initial=0)))
