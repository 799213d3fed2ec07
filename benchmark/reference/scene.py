"""The scene language, read by the reference on its own.

A small reader of the subset of j-dong/rust-raytrace's scene language
that the benchmark's scenes use: ``Plane`` and ``Sphere`` bounds,
``IndirectPhongMaterial``, no lights, ``SimplePerspectiveCamera new(...)``,
``SolidColorBackground`` and the ``options`` block.  Anything else raises,
so that a configuration the reference cannot judge is never judged.  The
scene's numbers come out as float64 numpy arrays under the names of the
port's ``SceneData`` leaves, so that gradients can be compared leaf by
leaf; the reference computes them from the text alone.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

_TOKEN = re.compile(
    r"\s+|#[^\n]*|//[^\n]*|/\*.*?\*/"
    r"|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)"
    r"|(?P<punct>[{}\[\]():,])", re.S)

SPHERE, PLANE = 0, 1
MIN_SIGNIFICANCE = 1.0 / 512.0   # raytrace.rs: significance gate
MAX_DEPTH = 4                     # raytrace.rs:17


def _tokens(text: str) -> list[tuple[str, object]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"scene text: cannot read {text[pos:pos + 20]!r}")
        pos = m.end()
        if m.group("name"):
            out.append(("name", m.group("name")))
        elif m.group("num"):
            out.append(("num", float(m.group("num"))))
        elif m.group("punct"):
            out.append((m.group("punct"), None))
    return out


class _Reader:
    def __init__(self, text: str):
        self.toks = _tokens(text)
        self.i = 0

    def peek(self, k: int = 0):
        j = self.i + k
        return self.toks[j][0] if j < len(self.toks) else None

    def take(self, kind: str):
        tok = self.toks[self.i]
        if tok[0] != kind:
            raise ValueError(f"scene text: expected {kind}, found {tok}")
        self.i += 1
        return tok[1]

    def items(self, close: str):
        out = []
        while self.peek() != close:
            out.append(self.value())
            if self.peek() == ",":
                self.take(",")
        self.take(close)
        return out

    def fields(self) -> dict:
        self.take("{")
        out = {}
        while self.peek() != "}":
            key = self.take("name")
            self.take(":")
            out[key] = self.value()
            if self.peek() == ",":
                self.take(",")
        self.take("}")
        return out

    def value(self):
        kind = self.peek()
        if kind == "num":
            return self.take("num")
        if kind == "(":
            self.take("(")
            return tuple(self.items(")"))
        if kind == "[":
            self.take("[")
            return self.items("]")
        if kind == "{":
            return self.fields()
        name = self.take("name")
        if self.peek() == "(":        # rgb(r, g, b)
            self.take("(")
            return tuple(self.items(")"))
        if self.peek() == "{":        # Class { fields }
            return (name, self.fields())
        if self.peek() == "name" and self.peek(1) == "(":  # Class new(args)
            ctor = self.take("name")
            self.take("(")
            return (name, ctor, self.items(")"))
        return name


@dataclasses.dataclass
class RefScene:
    """A scene as the reference holds it: float64 arrays named as the
    port's leaves, and the static facts the reference branches on."""

    arrays: dict
    shape: np.ndarray          # (O,) SPHERE or PLANE
    width: int
    height: int
    antialias: int
    max_depth: int = MAX_DEPTH

    @property
    def n_objects(self) -> int:
        return len(self.shape)


def _unit(v):
    return v / np.linalg.norm(v)


def parse(text: str) -> RefScene:
    """The :class:`RefScene` of a scene text in the subset above."""
    top = _Reader(text).value()
    if not isinstance(top, dict):
        raise ValueError("scene text: the top level is not a block")
    objs = top["objects"]
    if top.get("lights"):
        raise ValueError("the reference renders scenes without lights")
    n = len(objs)
    prim_p, prim_q = np.zeros((n, 3)), np.zeros((n, 3))
    diffuse, specular, ambient = (np.zeros((n, 3)) for _ in range(3))
    exponent, ior, samples = np.ones(n), np.ones(n), np.zeros(n)
    shape = np.zeros(n, np.int64)
    for i, o in enumerate(objs):
        kind, b = o["bounds"]
        if kind == "Sphere":
            shape[i] = SPHERE
            prim_p[i] = b["center"]
            prim_q[i, 0] = b["radius"]
        elif kind == "Plane":
            shape[i] = PLANE
            prim_p[i] = b["point"]
            prim_q[i] = b["normal"]
        else:
            raise ValueError(f"the reference has no bounds {kind}")
        mkind, m = o["material"]
        if mkind != "IndirectPhongMaterial":
            raise ValueError(f"the reference has no material {mkind}")
        diffuse[i], specular[i], ambient[i] = (m["diffuse"], m["specular"],
                                               m["ambient"])
        exponent[i], samples[i] = m["exponent"], m["samples"]
        if sum(m["specular"]) != 0.0 or m["samples"] != 1:
            raise ValueError("the reference's IndirectPhong has one sample "
                             "and no specular part")
    cam = top["camera"]
    if cam[0] != "SimplePerspectiveCamera" or cam[1] != "new":
        raise ValueError(f"the reference has no camera {cam[:2]}")
    pos, look, up, im_dist = (np.asarray(a, np.float64) for a in cam[2])
    # camera.rs:51-63: columns u = look x up, v = u x look, w = look
    u = _unit(np.cross(look, up))
    v = _unit(np.cross(u, look))
    w = _unit(look) * float(im_dist)
    bkind, bg = top["background"]
    if bkind != "SolidColorBackground":
        raise ValueError(f"the reference has no background {bkind}")
    opts = top["options"]
    arrays = dict(
        prim_p=prim_p, prim_q=prim_q, mat_diffuse=diffuse,
        mat_specular=specular, mat_exponent=exponent, mat_ambient=ambient,
        mat_ior=ior, mat_samples=samples,
        light_p=np.zeros((1, 3)), light_e1=np.zeros((1, 3)),
        light_e2=np.zeros((1, 3)), light_color=np.zeros((1, 3)),
        cam_position=pos, cam_matrix=np.stack([u, v, w], axis=1),
        cam_focus=np.float64(0.0), cam_aperture=np.float64(0.0),
        cam_im_dist=np.float64(np.linalg.norm(w)),
        bg_color=np.asarray(bg["color"], np.float64),
        bg_cube=np.zeros((6, 1, 1, 3)))
    return RefScene(arrays=arrays, shape=shape, width=int(opts["width"]),
                    height=int(opts["height"]),
                    antialias=int(opts["antialias"]))
