"""The scene language's lit fan-out subset, read by the lit tree reference
on its own.

Beside what :mod:`benchmark.reference.tree_scene` reads (its bounds, its
four materials, ``SolidColorBackground`` and the ``options`` block, with
the same refusals): the three lights of j-dong/rust-raytrace
(scene.rs:117-155), each ``{ model: <Light> { ... } color: rgb(...) }``

- ``PointLight { location }``;
- ``DirectionalLight { direction }``;
- ``AreaLight { origin side1 side2 }``;

and the depth-of-field camera ``DepthOfFieldCamera new(new(position,
look, up, im_dist), focus, aperture, samples)`` (camera.rs:83-123) beside
``SimplePerspectiveCamera new(...)``.  Anything else raises.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from benchmark.reference.scene import MAX_DEPTH, PLANE, SPHERE, _Reader, _unit
from benchmark.reference.tree_scene import (_FIELDS, _KINDS, INDIRECT,
                                            TRANSPARENT, TreeScene)

POINT, DIRECTIONAL, AREA = 0, 1, 2
# each light's model and its fields (serialize.rs)
_LIGHTS = {"PointLight": (POINT, {"location"}),
           "DirectionalLight": (DIRECTIONAL, {"direction"}),
           "AreaLight": (AREA, {"origin", "side1", "side2"})}


@dataclasses.dataclass
class LitScene(TreeScene):
    """A :class:`TreeScene` with lights and the camera's lens samples."""

    light_kind: tuple = ()     # POINT, DIRECTIONAL or AREA, per light
    dof: bool = False          # the depth-of-field camera
    cam_samples: int = 1       # its lens samples (1 for the simple one)

    @property
    def n_lights(self) -> int:
        return len(self.light_kind)


def _objects(objs) -> dict:
    """The object and material arrays, and each object's material kind,
    as :func:`benchmark.reference.tree_scene.parse` reads them."""
    n = len(objs)
    out = {k: np.zeros((n, 3)) for k in ("prim_p", "prim_q", "mat_diffuse",
                                          "mat_specular", "mat_ambient")}
    out.update(mat_exponent=np.ones(n), mat_ior=np.ones(n),
               mat_samples=np.zeros(n), shape=np.zeros(n, np.int64),
               kind=np.zeros(n, np.int64))
    for i, o in enumerate(objs):
        bkind, b = o["bounds"]
        if bkind == "Sphere":
            out["shape"][i] = SPHERE
            out["prim_p"][i] = b["center"]
            out["prim_q"][i, 0] = b["radius"]
        elif bkind == "Plane":
            out["shape"][i] = PLANE
            out["prim_p"][i] = b["point"]
            out["prim_q"][i] = b["normal"]
        else:
            raise ValueError(f"the lit tree reference has no bounds {bkind}")
        mname, m = o["material"]
        if mname not in _KINDS:
            raise ValueError(f"the lit tree reference has no material "
                             f"{mname}")
        out["kind"][i] = k = _KINDS[mname]
        if set(m) != _FIELDS[k]:
            raise ValueError(f"{mname} with fields {sorted(m)}")
        out["mat_specular"][i] = m["specular"]
        out["mat_exponent"][i] = m["exponent"]
        if k != TRANSPARENT:
            out["mat_diffuse"][i], out["mat_ambient"][i] = (m["diffuse"],
                                                            m["ambient"])
        if "ior" in m:
            out["mat_ior"][i] = m["ior"]
        if k == INDIRECT:
            out["mat_samples"][i] = m["samples"]
            if sum(m["specular"]) != 0.0:
                raise ValueError("the lit tree reference's IndirectPhong has "
                                 "no specular part")
    return out


def _lights(lights) -> tuple[tuple, dict]:
    """Each light's kind, and its (L, 3) arrays: position (a point light's
    location, an area light's origin), first edge (a directional light's
    direction, an area light's side1), second edge, colour."""
    n = max(len(lights), 1)
    arr = {k: np.zeros((n, 3)) for k in ("light_p", "light_e1", "light_e2",
                                          "light_color")}
    kinds = []
    for i, lt in enumerate(lights):
        if set(lt) != {"model", "color"}:
            raise ValueError(f"a light with fields {sorted(lt)}")
        model, f = lt["model"]
        if model not in _LIGHTS:
            raise ValueError(f"the lit tree reference has no light {model}")
        kind, fields = _LIGHTS[model]
        if set(f) != fields:
            raise ValueError(f"{model} with fields {sorted(f)}")
        kinds.append(kind)
        arr["light_color"][i] = lt["color"]
        if kind == POINT:
            arr["light_p"][i] = f["location"]
        elif kind == DIRECTIONAL:
            arr["light_e1"][i] = f["direction"]
        else:
            arr["light_p"][i] = f["origin"]
            arr["light_e1"][i] = f["side1"]
            arr["light_e2"][i] = f["side2"]
    return tuple(kinds), arr


def _camera(cam) -> tuple[dict, bool, int]:
    """The camera's arrays, whether it is the depth-of-field one, and its
    lens samples."""
    kind, ctor, args = cam if len(cam) == 3 else (cam[0], None, None)
    dof = kind == "DepthOfFieldCamera"
    if ctor != "new" or not (dof or kind == "SimplePerspectiveCamera"):
        raise ValueError(f"the lit tree reference has no camera {cam[:2]}")
    if dof:
        # the inner camera reads as the tuple of its arguments: new(...) has
        # four (look_at(...), which the reference does not read, has five)
        base, focus, aperture, samples = args
        if len(base) != 4:
            raise ValueError("the lit tree reference's depth-of-field camera "
                             "wraps new(position, look, up, im_dist)")
    else:
        base, focus, aperture, samples = args, 0.0, 0.0, 1
    pos, look, up, im_dist = (np.asarray(a, np.float64) for a in base)
    # camera.rs:51-63: columns u = look x up, v = u x look, w = look
    u = _unit(np.cross(look, up))
    v = _unit(np.cross(u, look))
    w = _unit(look) * float(im_dist)
    return dict(cam_position=pos, cam_matrix=np.stack([u, v, w], axis=1),
                cam_focus=np.float64(focus),
                cam_aperture=np.float64(aperture),
                # DepthOfFieldCamera::new keeps |M (0, 0, 1)| (camera.rs:98)
                cam_im_dist=np.float64(np.linalg.norm(w))), dof, int(samples)


def parse(text: str) -> LitScene:
    """The :class:`LitScene` of a scene text in the subset above."""
    top = _Reader(text).value()
    if not isinstance(top, dict):
        raise ValueError("scene text: the top level is not a block")
    obj = _objects(top["objects"])
    shape, kind = obj.pop("shape"), obj.pop("kind")
    light_kind, lights = _lights(top.get("lights") or [])
    cam, dof, cam_samples = _camera(top["camera"])
    if cam_samples < 1:
        raise ValueError(f"a camera of {cam_samples} lens samples")
    bkind, bg = top["background"]
    if bkind != "SolidColorBackground":
        raise ValueError(f"the lit tree reference has no background {bkind}")
    opts = top["options"]
    if set(opts) != {"width", "height", "antialias"}:
        raise ValueError(f"the lit tree reference has no options "
                         f"{sorted(opts)}")
    spec_sig = obj["mat_specular"].sum(axis=1) > 0.0
    indirect = (kind == INDIRECT) & (obj["mat_diffuse"].sum(axis=1) > 0.0)
    return LitScene(
        arrays=dict(obj, **lights, **cam,
                    bg_color=np.asarray(bg["color"], np.float64)),
        shape=shape, width=int(opts["width"]), height=int(opts["height"]),
        antialias=int(opts["antialias"]), max_depth=MAX_DEPTH, kind=kind,
        has_reflect=bool(np.any((kind != INDIRECT) & spec_sig)),
        has_refract=bool(np.any(kind == TRANSPARENT)),
        n_indirect=int(obj["mat_samples"][indirect].max(initial=0)),
        light_kind=light_kind, dof=dof, cam_samples=cam_samples)
