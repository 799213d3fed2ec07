"""Scene-description-language parser.

Host-side re-implementation of the reference's hand-written LL(1) lexer +
recursive-descent parser (``src/serialize.rs``, 814 LoC; SURVEY.md §2 #16).
Accepts the same grammar:

* tokens: identifiers, double-quoted strings (escapes ``\\n \\r \\t \\\\ \\0
  \\' \\" \\xHH \\u{...}``, backslash-newline eats following whitespace,
  unknown escapes are skipped — serialize.rs:295-356), numbers (f64),
  ``{ } [ ] ( ) : ,``;
* comments: ``#``, ``//`` and ``/* */`` (serialize.rs:388-404);
* structs ``Name { field: value ... }`` with order-free, all-required
  fields; unknown field => "undefined field", missing => "missing one or
  more fields" (serialize.rs:524-550);
* polymorphic boxes ``ClassName <body>`` with "no such class" errors;
* constructor calls ``new(...)`` / ``look_at(...)`` for cameras
  (serialize.rs:627-656);
* angle literals ``<num> deg | rad`` (serialize.rs:476-488);
* int coercion warnings (serialize.rs:449-469).

Errors carry ``row:col`` locations and the reference's message shapes
("expected X", "no such class: Y", ...).

The parser produces a plain-Python AST (dataclasses below); the device-side
scene pytree is assembled by :mod:`raytrace_tpu_torch.scene.builder`.  Unlike the
reference (serialize.rs:760-765), texture I/O does NOT happen inside the
parser — the AST records paths and the builder loads them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator

# ------------------------------------------------------------------ AST ---


@dataclasses.dataclass
class SphereAst:
    center: tuple[float, float, float]
    radius: float


@dataclasses.dataclass
class PlaneAst:
    point: tuple[float, float, float]
    normal: tuple[float, float, float]


@dataclasses.dataclass
class MaterialAst:
    kind: str                      # Phong | IndirectPhong | Fresnel | Transparent
    diffuse: tuple = (0.0, 0.0, 0.0)
    specular: tuple = (0.0, 0.0, 0.0)
    exponent: float = 1.0
    ambient: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.0
    samples: int = 0


@dataclasses.dataclass
class ObjectAst:
    bounds: SphereAst | PlaneAst
    material: MaterialAst


@dataclasses.dataclass
class LightAst:
    kind: str                      # Point | Directional | Area
    color: tuple
    location: tuple = (0.0, 0.0, 0.0)   # point
    direction: tuple = (0.0, 0.0, 0.0)  # directional
    origin: tuple = (0.0, 0.0, 0.0)     # area
    side1: tuple = (0.0, 0.0, 0.0)
    side2: tuple = (0.0, 0.0, 0.0)


@dataclasses.dataclass
class CameraAst:
    kind: str                      # SimplePerspective | DepthOfField
    position: tuple = (0.0, 0.0, 0.0)
    look: tuple = (0.0, 0.0, -1.0)
    up: tuple = (0.0, 1.0, 0.0)
    im_dist: float = 1.0
    mode: str = "new"              # new | look_at
    focus_point: tuple = (0.0, 0.0, 0.0)  # look_at focus
    pov: float = 0.0
    h: float = 0.0
    # DoF extras
    dof_focus: float = 0.0
    aperture: float = 0.0
    samples: int = 1


@dataclasses.dataclass
class BackgroundAst:
    kind: str                      # SolidColor | Skybox
    color: tuple = (0.0, 0.0, 0.0)
    faces: tuple[str, ...] = ()    # px nx py ny pz nz texture paths


@dataclasses.dataclass
class OptionsAst:
    width: int
    height: int
    antialias: int


@dataclasses.dataclass
class SceneAst:
    objects: list[ObjectAst]
    lights: list[LightAst]
    camera: CameraAst
    background: BackgroundAst
    options: OptionsAst


# ---------------------------------------------------------------- errors ---


class SceneSyntaxError(Exception):
    """Mirrors serialize.rs SyntaxError: '{row}:{col}: {message}'."""

    def __init__(self, message: str, row: int, col: int):
        self.message = message
        self.row = row
        self.col = col
        super().__init__(f"{row}:{col}: {message}")


# ----------------------------------------------------------------- lexer ---

_PUNCT = {"{": "LBrace", "}": "RBrace", "[": "LBracket", "]": "RBracket",
          "(": "LParen", ")": "RParen", ":": "Colon", ",": "Comma"}

_IDENT_START = set("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_")
_IDENT_CONT = _IDENT_START | set("0123456789")
_NUM_START = set("0123456789.-+")
_NUM_CONT = _IDENT_CONT | set(".-+")


@dataclasses.dataclass
class Token:
    kind: str        # Identifier | String | Number | <punct kinds>
    value: object
    row: int
    col: int

    def __repr__(self):  # for "expected X, not Y" messages
        if self.kind in ("Identifier", "String"):
            return f'{self.kind}("{self.value}")'
        if self.kind == "Number":
            return f"Number({self.value})"
        return self.kind


class _Chars:
    """Char stream with reference-style row:col tracking
    (serialize.rs:22-65: rows from 1, col incremented per consumed char,
    reset to 0 on newline)."""

    def __init__(self, text: str):
        self.text = text
        self.i = 0
        self.row = 1
        self.col = 0

    def peek(self) -> str | None:
        return self.text[self.i] if self.i < len(self.text) else None

    def take(self) -> str | None:
        c = self.peek()
        if c is None:
            return None
        self.i += 1
        if c == "\n":
            self.row += 1
            self.col = 0
        else:
            self.col += 1
        return c

    def skip_while(self, pred: Callable[[str], bool]) -> None:
        while (c := self.peek()) is not None and pred(c):
            self.take()

    def take_while(self, pred: Callable[[str], bool]) -> str:
        out = []
        while (c := self.peek()) is not None and pred(c):
            out.append(self.take())
        return "".join(out)


def _parse_string_body(cs: _Chars) -> str:
    """String contents after the opening quote (serialize.rs:295-356)."""
    out: list[str] = []
    while True:
        c = cs.take()
        if c is None:
            return "".join(out)  # EOF inside string: reference yields what it has
        if c == '"':
            return "".join(out)
        if c != "\\":
            out.append(c)
            continue
        e = cs.take()
        if e is None:
            return "".join(out)
        simple = {"n": "\n", "r": "\r", "t": "\t", "\\": "\\", "0": "\0",
                  "'": "'", '"': '"'}
        if e in simple:
            out.append(simple[e])
        elif e == "x":
            a = cs.take()
            if a is None or not _ishex(a):
                cs.take()          # serialize.rs:320 skips one extra char
                continue
            b = cs.take()
            if b is None or not _ishex(b):
                continue
            code = int(a, 16) * 16 + int(b, 16)
            try:
                out.append(chr(code))
            except ValueError:
                pass
        elif e == "u":
            if cs.peek() != "{":
                continue
            cs.take()
            acc = 0
            bad = False
            while cs.peek() != "}":
                d = cs.take()
                if d is None:
                    return "".join(out)
                if not _ishex(d):
                    # serialize.rs:339: skip to closing brace, drop escape
                    cs.skip_while(lambda ch: ch != "}")
                    bad = True
                    break
                acc = acc * 16 + int(d, 16)
            if cs.peek() == "}":
                cs.take()
            if not bad:
                try:
                    out.append(chr(acc))
                except ValueError:
                    pass
        elif e == "\n":
            cs.skip_while(str.isspace)
        # unknown escapes: skipped (serialize.rs:348)


def _ishex(c: str) -> bool:
    return c in "0123456789abcdefABCDEF"


def tokenize(text: str) -> Iterator[Token]:
    """Lex the scene source (serialize.rs:362-417).  Raises
    :class:`SceneSyntaxError` for invalid tokens / numbers."""
    cs = _Chars(text)
    while True:
        cs.skip_while(str.isspace)
        c = cs.peek()
        if c is None:
            return
        row, col = cs.row, cs.col
        if c in _PUNCT:
            cs.take()
            yield Token(_PUNCT[c], c, cs.row, cs.col)
        elif c == "#":
            cs.skip_while(lambda ch: ch != "\n")
        elif c == "/":
            cs.take()
            nxt = cs.take()
            if nxt == "/":
                cs.skip_while(lambda ch: ch != "\n")
            elif nxt == "*":
                while True:
                    cs.skip_while(lambda ch: ch != "*")
                    cs.take()  # the '*' (or EOF)
                    t = cs.take()
                    if t == "/" or t is None:
                        break
            else:
                raise SceneSyntaxError("invalid token", cs.row, cs.col)
        elif c == '"':
            cs.take()
            s = _parse_string_body(cs)
            yield Token("String", s, cs.row, cs.col)
        elif c in _IDENT_START:
            ident = cs.take_while(lambda ch: ch in _IDENT_CONT)
            yield Token("Identifier", ident, cs.row, cs.col)
        elif c in _NUM_START:
            num = cs.take_while(lambda ch: ch in _NUM_CONT)
            val = _rust_f64(num)
            if val is None:
                raise SceneSyntaxError(f"invalid number: {num}", cs.row, cs.col)
            yield Token("Number", val, cs.row, cs.col)
        else:
            raise SceneSyntaxError("invalid token", cs.row, cs.col)
        del row, col


def _rust_f64(s: str) -> float | None:
    """Parse like Rust's ``f64::from_str`` (stricter than Python float):
    no underscores, no 'infinity'/'nan' words beyond Rust's inf/NaN (which
    cannot be lexed here anyway since numbers start with [0-9.+-])."""
    if "_" in s:
        return None
    try:
        return float(s)
    except ValueError:
        return None


# ---------------------------------------------------------------- parser ---


class _Parser:
    def __init__(self, text: str):
        self._it = tokenize(text)
        self._peeked: Token | None = None
        self._row, self._col = 1, 0

    # -- token plumbing --
    def peek(self) -> Token | None:
        if self._peeked is None:
            self._peeked = next(self._it, None)
        return self._peeked

    def take(self) -> Token | None:
        t = self.peek()
        self._peeked = None
        if t is not None:
            self._row, self._col = t.row, t.col
        return t

    def _err(self, msg: str) -> SceneSyntaxError:
        t = self.peek()
        row, col = (t.row, t.col) if t is not None else (self._row, self._col)
        return SceneSyntaxError(msg, row, col)

    def expect(self, kind: str, desc: str | None = None) -> Token:
        t = self.peek()
        if t is None:
            raise self._err(f"expected {desc or kind} (end of file)")
        if t.kind != kind:
            raise self._err(f"expected {desc or kind}, not {t!r}")
        return self.take()

    def accept(self, kind: str) -> Token | None:
        t = self.peek()
        if t is not None and t.kind == kind:
            return self.take()
        return None

    def expect_ident(self, name: str) -> Token:
        t = self.peek()
        if t is None:
            raise self._err(f'expected Identifier("{name}") (end of file)')
        if t.kind != "Identifier" or t.value != name:
            raise self._err(f'expected Identifier("{name}"), not {t!r}')
        return self.take()

    # -- scalar parsers (serialize.rs:443-522) --
    def f64(self) -> float:
        return self.expect("Number").value

    def i32(self) -> int:
        num = self.f64()
        if abs(num - round(num)) > 0.01:
            print(f"Warning: {num} stored as integer")
        if abs(num) > 1677215.0:
            print("Warning: integer values past ~2^24+1 are not exact")
        return int(round(num))

    def u32(self) -> int:
        num = self.i32()
        if num < 0:
            print(f"Warning: unsigned integer {num} is negative, using 0")
            return 0
        return num

    def string(self) -> str:
        return self.expect("String").value

    def ang(self) -> float:
        num = self.f64()
        unit = self.expect("Identifier").value
        if unit == "deg":
            return num * math.pi / 180.0
        if unit == "rad":
            return num
        raise self._err(f"no such class: {unit}")

    def vec3(self) -> tuple[float, float, float]:
        self.expect("LParen")
        x = self.f64()
        self.expect("Comma")
        y = self.f64()
        self.expect("Comma")
        z = self.f64()
        self.expect("RParen")
        return (x, y, z)

    pnt3 = vec3

    def color(self) -> tuple[float, float, float]:
        self.expect_ident("rgb")
        return self.vec3()

    # -- struct machinery (serialize.rs:524-550) --
    def struct_body(self, fields: dict[str, Callable[[], object]]) -> dict:
        self.expect("LBrace")
        got: dict[str, object] = {}
        while self.accept("RBrace") is None:
            name_tok = self.expect("Identifier")
            name = name_tok.value
            if name not in fields:
                raise SceneSyntaxError(f"undefined field: {name}",
                                       self._row, self._col)
            self.expect("Colon")
            got[name] = fields[name]()
        if set(got) != set(fields):
            raise SceneSyntaxError("missing one or more fields",
                                   self._row, self._col)
        return got

    def boxed(self, classes: dict[str, Callable[[], object]]):
        t = self.expect("Identifier")
        cls = t.value
        if cls not in classes:
            raise SceneSyntaxError(f"no such class: {cls}", self._row, self._col)
        return classes[cls]()

    def vec(self, parser: Callable[[], object]) -> list:
        self.expect("LBracket")
        out = []
        while self.accept("RBracket") is None:
            out.append(parser())
        return out

    # -- concrete grammar (serialize.rs:606-814) --
    def sphere(self) -> SphereAst:
        f = self.struct_body({"center": self.pnt3, "radius": self.f64})
        return SphereAst(center=f["center"], radius=f["radius"])

    def plane(self) -> PlaneAst:
        f = self.struct_body({"point": self.pnt3, "normal": self.vec3})
        return PlaneAst(point=f["point"], normal=f["normal"])

    def shape(self):
        return self.boxed({"Sphere": self.sphere, "Plane": self.plane})

    def material(self) -> MaterialAst:
        def phong():
            f = self.struct_body({"diffuse": self.color, "specular": self.color,
                                  "exponent": self.f64, "ambient": self.color})
            return MaterialAst(kind="Phong", **f)

        def indirect():
            f = self.struct_body({"diffuse": self.color, "specular": self.color,
                                  "exponent": self.f64, "ambient": self.color,
                                  "samples": self.u32})
            return MaterialAst(kind="IndirectPhong", **f)

        def fresnel():
            f = self.struct_body({"diffuse": self.color, "specular": self.color,
                                  "exponent": self.f64, "ambient": self.color,
                                  "ior": self.f64})
            return MaterialAst(kind="Fresnel", **f)

        def transparent():
            f = self.struct_body({"specular": self.color, "exponent": self.f64,
                                  "ior": self.f64})
            return MaterialAst(kind="Transparent", **f)

        return self.boxed({"PhongMaterial": phong,
                           "IndirectPhongMaterial": indirect,
                           "FresnelMaterial": fresnel,
                           "TransparentMaterial": transparent})

    def object(self) -> ObjectAst:
        f = self.struct_body({"bounds": self.shape, "material": self.material})
        return ObjectAst(bounds=f["bounds"], material=f["material"])

    def light(self) -> LightAst:
        def point():
            f = self.struct_body({"location": self.pnt3})
            return ("Point", f)

        def directional():
            f = self.struct_body({"direction": self.vec3})
            return ("Directional", f)

        def area():
            f = self.struct_body({"origin": self.pnt3, "side1": self.vec3,
                                  "side2": self.vec3})
            return ("Area", f)

        def model():
            return self.boxed({"PointLight": point,
                               "DirectionalLight": directional,
                               "AreaLight": area})

        f = self.struct_body({"model": model, "color": self.color})
        kind, mf = f["model"]
        return LightAst(kind=kind, color=f["color"], **mf)

    def _spc_call(self) -> CameraAst:
        """``new(...)`` or ``look_at(...)`` (serialize.rs:627-646)."""
        t = self.peek()
        if t is None or t.kind != "Identifier":
            raise self._err(f'expected Identifier("new"), not '
                            f'{"(end of file)" if t is None else repr(t)}')
        if t.value == "new":
            self.take()
            self.expect("LParen")
            position = self.pnt3()
            self.expect("Comma")
            look = self.vec3()
            self.expect("Comma")
            up = self.vec3()
            self.expect("Comma")
            im_dist = self.f64()
            self.expect("RParen")
            return CameraAst(kind="SimplePerspective", mode="new",
                             position=position, look=look, up=up,
                             im_dist=im_dist)
        if t.value == "look_at":
            self.take()
            self.expect("LParen")
            focus = self.pnt3()
            self.expect("Comma")
            look = self.vec3()
            self.expect("Comma")
            up = self.vec3()
            self.expect("Comma")
            pov = self.ang()
            self.expect("Comma")
            h = self.f64()
            self.expect("RParen")
            return CameraAst(kind="SimplePerspective", mode="look_at",
                             focus_point=focus, look=look, up=up,
                             pov=pov, h=h)
        raise self._err(f'expected Identifier("new"), not {t!r}')

    def camera(self) -> CameraAst:
        def dof():
            self.expect_ident("new")
            self.expect("LParen")
            base = self._spc_call()
            self.expect("Comma")
            focus = self.f64()
            self.expect("Comma")
            aperture = self.f64()
            self.expect("Comma")
            samples = self.u32()
            self.expect("RParen")
            return dataclasses.replace(base, kind="DepthOfField",
                                       dof_focus=focus, aperture=aperture,
                                       samples=samples)

        return self.boxed({"SimplePerspectiveCamera": self._spc_call,
                           "DepthOfFieldCamera": dof})

    def background(self) -> BackgroundAst:
        def solid():
            f = self.struct_body({"color": self.color})
            return BackgroundAst(kind="SolidColor", color=f["color"])

        def load_texture() -> str:
            self.expect_ident("load")
            self.expect("LParen")
            path = self.string()
            self.expect("RParen")
            return path

        def skybox():
            f = self.struct_body({k: load_texture
                                  for k in ("px", "nx", "py", "ny", "pz", "nz")})
            return BackgroundAst(kind="Skybox",
                                 faces=tuple(f[k] for k in
                                             ("px", "nx", "py", "ny", "pz", "nz")))

        return self.boxed({"SolidColorBackground": solid,
                           "SkyboxBackground": skybox})

    def options(self) -> OptionsAst:
        f = self.struct_body({"width": self.u32, "height": self.u32,
                              "antialias": self.u32})
        return OptionsAst(**f)

    def scene(self) -> SceneAst:
        f = self.struct_body({
            "objects": lambda: self.vec(self.object),
            "lights": lambda: self.vec(self.light),
            "camera": self.camera,
            "background": self.background,
            "options": self.options,
        })
        return SceneAst(objects=f["objects"], lights=f["lights"],
                        camera=f["camera"], background=f["background"],
                        options=f["options"])


def parse(text: str) -> SceneAst:
    """Parse scene source to an AST.  Raises :class:`SceneSyntaxError`."""
    return _Parser(text).scene()


def deserialize(text: str, *, device):
    """Parse scene source and build the device scene
    (serialize.rs:427-441 equivalent).  Returns a
    :class:`raytrace_tpu_torch.scene.schema.Scene` on ``device``."""
    from raytrace_tpu_torch.scene.builder import build_scene

    return build_scene(parse(text), device=device)
