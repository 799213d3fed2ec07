"""Scene builder: parsed AST -> padded tensor scene.

PyTorch counterpart of :mod:`raytrace_tpu.scene.builder`.  Everything is
computed in numpy float64 (camera matrix included) and cast to the
requested dtype and device at the end, so the leaves equal those of
:mod:`raytrace_tpu.scene.builder` exactly.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from raytrace_tpu_torch import color as colorlib
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.schema import (
    BG_SKYBOX, BG_SOLID, CAM_DEPTH_OF_FIELD, CAM_SIMPLE_PERSPECTIVE, LIGHT_AREA,
    LIGHT_DIRECTIONAL, LIGHT_POINT, MAT_FRESNEL, MAT_INDIRECT_PHONG,
    MAT_PHONG, MAT_TRANSPARENT, SHAPE_PLANE, SHAPE_SPHERE, Scene, SceneSpec,
    scene_data_from_numpy,
)

_MAT_IDS = {"Phong": MAT_PHONG, "IndirectPhong": MAT_INDIRECT_PHONG,
            "Fresnel": MAT_FRESNEL, "Transparent": MAT_TRANSPARENT}
_LIGHT_IDS = {"Point": LIGHT_POINT, "Directional": LIGHT_DIRECTIONAL,
              "Area": LIGHT_AREA}


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def camera_matrix(position, look, up, im_dist) -> tuple[np.ndarray, np.ndarray]:
    """SimplePerspectiveCamera::new (camera.rs:51-63) in f64.

    Columns (u, v, w): u = unit(look x up), v = unit(u x look),
    w = unit(look) * im_dist; ray dir = M @ (x, y, 1).
    """
    look = np.asarray(look, np.float64)
    up = np.asarray(up, np.float64)
    u = _normalize(np.cross(look, up))
    v = _normalize(np.cross(u, look))
    w = _normalize(look) * im_dist
    return np.asarray(position, np.float64), np.stack([u, v, w], axis=1)


def camera_look_at(focus, look, up, pov, h) -> tuple[np.ndarray, np.ndarray]:
    """SimplePerspectiveCamera::look_at (camera.rs:67-73)."""
    cot = 1.0 / np.tan(pov / 2.0)
    d = h * cot
    position = np.asarray(focus, np.float64) - _normalize(
        np.asarray(look, np.float64)) * d
    return camera_matrix(position, look, up, cot)


def _read_bmp_rgb(blob: bytes) -> np.ndarray | None:
    """The (H, W, 3) uint8 RGB pixels, top row first, of an uncompressed
    24-bit BMP (what :mod:`raytrace_tpu_torch.io.bmp` writes), or None
    for any other file."""
    if len(blob) < 54 or blob[:2] != b"BM":
        return None
    offset, = struct.unpack("<I", blob[10:14])
    dib, = struct.unpack("<I", blob[14:18])
    if dib < 40:
        return None
    width, height = struct.unpack("<ii", blob[18:26])
    planes, bpp, compression = struct.unpack("<HHI", blob[26:34])
    stride = (3 * width + 3) & ~3
    if (planes != 1 or bpp != 24 or compression != 0 or width <= 0
            or height == 0 or len(blob) < offset + stride * abs(height)):
        return None
    rows = np.frombuffer(blob, np.uint8, count=stride * abs(height),
                         offset=offset).reshape(abs(height), stride)
    rgb = rows[:, :3 * width].reshape(abs(height), width, 3)[..., ::-1]
    # a positive height stores the bottom row first
    return rgb[::-1] if height > 0 else rgb


def load_texture(path: str) -> np.ndarray:
    """Load an image file to a linear-RGB f64 array (H, W, 3), top row
    first (texture.rs:34-42): sRGB bytes decoded through the
    ``SRGB_VALUES`` table, like Texture::at (texture.rs:39-42).

    Uncompressed 24-bit BMP files are read with numpy alone; any other
    format goes through Pillow, imported here, where it is installed.  A
    file that cannot be read gives the ``SceneSyntaxError`` of a failed
    texture load."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
        rgb = _read_bmp_rgb(blob)
        if rgb is None:
            import io

            from PIL import Image

            with Image.open(io.BytesIO(blob)) as im:
                rgb = np.asarray(im.convert("RGB"), dtype=np.uint8)
    except Exception as e:  # noqa: BLE001 -- the TextureLoad error's shape
        raise dsl.SceneSyntaxError(f'error loading "{path}": {e}', 0, 0)
    return colorlib.SRGB_VALUES[rgb]


def build_scene(ast: dsl.SceneAst, *, device, dtype=torch.float32,
                scene_dir: str | None = None) -> Scene:
    """Assemble the tensor scene on ``device`` from a parsed AST.  Skybox
    face paths that are relative are taken against ``scene_dir``."""
    n_obj = max(len(ast.objects), 1)
    prim_p = np.zeros((n_obj, 3))
    prim_q = np.zeros((n_obj, 3))
    shape_type = [-1] * n_obj
    mat_type = [-1] * n_obj
    diffuse = np.zeros((n_obj, 3))
    specular = np.zeros((n_obj, 3))
    exponent = np.ones(n_obj)
    ambient = np.zeros((n_obj, 3))
    ior = np.ones(n_obj)
    samples = np.zeros(n_obj)

    has_reflect = False
    has_refract = False
    n_indirect = 0
    for i, obj in enumerate(ast.objects):
        b = obj.bounds
        if isinstance(b, dsl.SphereAst):
            shape_type[i] = SHAPE_SPHERE
            prim_p[i] = b.center
            prim_q[i, 0] = b.radius
        else:
            shape_type[i] = SHAPE_PLANE
            prim_p[i] = b.point
            prim_q[i] = b.normal
        m = obj.material
        mat_type[i] = _MAT_IDS[m.kind]
        diffuse[i] = m.diffuse
        specular[i] = m.specular
        exponent[i] = m.exponent
        ambient[i] = m.ambient
        ior[i] = m.ior
        samples[i] = m.samples
        spec_sig = sum(m.specular) > 0.0
        if m.kind in ("Phong", "Fresnel", "Transparent") and spec_sig:
            has_reflect = True
        if m.kind == "Transparent":
            has_refract = True
        if m.kind == "IndirectPhong" and (sum(m.diffuse) > 0 or spec_sig):
            n_indirect = max(n_indirect, m.samples)

    n_l = len(ast.lights)
    light_type = []
    light_p = np.zeros((max(n_l, 1), 3))
    light_e1 = np.zeros((max(n_l, 1), 3))
    light_e2 = np.zeros((max(n_l, 1), 3))
    light_color = np.zeros((max(n_l, 1), 3))
    for i, lt in enumerate(ast.lights):
        light_type.append(_LIGHT_IDS[lt.kind])
        light_color[i] = lt.color
        if lt.kind == "Point":
            light_p[i] = lt.location
        elif lt.kind == "Directional":
            light_e1[i] = lt.direction
        else:
            light_p[i] = lt.origin
            light_e1[i] = lt.side1
            light_e2[i] = lt.side2

    cam = ast.camera
    if cam.mode == "new":
        cam_pos, cam_mat = camera_matrix(cam.position, cam.look, cam.up,
                                         cam.im_dist)
    else:
        cam_pos, cam_mat = camera_look_at(cam.focus_point, cam.look, cam.up,
                                          cam.pov, cam.h)
    # DepthOfFieldCamera::new caches |M @ (0,0,1)| (camera.rs:98)
    im_dist_cache = np.linalg.norm(cam_mat @ np.array([0.0, 0.0, 1.0]))
    cam_type = (CAM_DEPTH_OF_FIELD if cam.kind == "DepthOfField"
                else CAM_SIMPLE_PERSPECTIVE)
    cam_samples = cam.samples if cam.kind == "DepthOfField" else 1

    bg = ast.background
    if bg.kind == "Skybox":
        bg_type = BG_SKYBOX
        faces = [load_texture(p if scene_dir is None or os.path.isabs(p)
                              else os.path.join(scene_dir, p))
                 for p in bg.faces]
        face_sizes = tuple((t.shape[0], t.shape[1]) for t in faces)
        # the faces padded into one cube; each is clamped to its own size
        cube = np.zeros((6, max(h for h, _ in face_sizes),
                         max(w for _, w in face_sizes), 3))
        for i, t in enumerate(faces):
            cube[i, :t.shape[0], :t.shape[1]] = t
        bg_color = np.zeros(3)
    else:
        bg_type = BG_SOLID
        cube = np.zeros((6, 1, 1, 3))
        face_sizes = ((1, 1),) * 6
        bg_color = np.asarray(bg.color, np.float64)

    spec = SceneSpec(
        shape_type=tuple(shape_type),
        mat_type=tuple(mat_type),
        light_type=tuple(light_type),
        cam_type=cam_type,
        cam_samples=max(cam_samples, 1),
        bg_type=bg_type,
        width=ast.options.width,
        height=ast.options.height,
        antialias=ast.options.antialias,
        has_reflect=has_reflect,
        has_refract=has_refract,
        n_indirect=n_indirect,
        face_sizes=face_sizes,
    )
    arrays = dict(
        prim_p=prim_p, prim_q=prim_q,
        mat_diffuse=diffuse, mat_specular=specular,
        mat_exponent=exponent, mat_ambient=ambient,
        mat_ior=ior, mat_samples=samples,
        light_p=light_p, light_e1=light_e1, light_e2=light_e2,
        light_color=light_color,
        cam_position=cam_pos, cam_matrix=cam_mat,
        cam_focus=np.float64(cam.dof_focus),
        cam_aperture=np.float64(cam.aperture),
        cam_im_dist=im_dist_cache,
        bg_color=bg_color, bg_cube=cube,
    )
    return Scene(data=scene_data_from_numpy(arrays, device, dtype),
                 spec=spec)


def load_scene_file(path: str, *, device, dtype=torch.float32) -> Scene:
    """Read, parse and build a scene file (main.rs:15-30) on ``device``."""
    with open(path, "r") as fh:
        text = fh.read()
    return build_scene(dsl.parse(text), device=device, dtype=dtype,
                       scene_dir=os.path.dirname(os.path.abspath(path)))
