"""Scene representation: a padded structure-of-arrays of tensors.

PyTorch counterpart of :mod:`raytrace_tpu.scene.schema`.  The scene is
two pieces:

* :class:`SceneData` -- a dataclass of padded tensors (geometry, material
  table, light table, camera, background) that all live on one device.
* :class:`SceneSpec` -- the static, hashable half: sizes, type tags that
  select code paths, and render options.  It is framework-free and has
  the same fields and properties as the JAX package's.

Objects keep their scene-file order on one padded object axis, so
closest-hit keeps the first-minimum tie-break of the reference
(scene.rs:247-249).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

# Shape type ids (shapes.rs: Sphere, Plane)
SHAPE_SPHERE = 0
SHAPE_PLANE = 1

# Material type ids (scene.rs:32-89)
MAT_PHONG = 0
MAT_INDIRECT_PHONG = 1
MAT_FRESNEL = 2
MAT_TRANSPARENT = 3

# Light model ids (scene.rs:117-155)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_AREA = 2

# Camera type ids (camera.rs)
CAM_SIMPLE_PERSPECTIVE = 0
CAM_DEPTH_OF_FIELD = 1

# Background type ids (scene.rs:159-188)
BG_SOLID = 0
BG_SKYBOX = 1

# Render-engine constants (raytrace.rs:17-18)
MIN_SIGNIFICANCE = 1.0 / 256.0 / 2.0
MAX_DEPTH = 4


@dataclasses.dataclass
class SceneData:
    """Scene parameters as tensors on one device.

    Axis O = padded object count, L = padded light count.  Padding rows
    are masked through ``SceneSpec.shape_type < 0`` / ``light_type < 0``.
    """

    # geometry, type-unioned per object (shapes.rs:43-112)
    # sphere: prim_p = center, prim_q[0] = radius
    # plane:  prim_p = point,  prim_q = normal (raw, not normalized)
    prim_p: torch.Tensor        # (O, 3)
    prim_q: torch.Tensor        # (O, 3)

    # material table (scene.rs:32-89), one row per object
    mat_diffuse: torch.Tensor   # (O, 3)
    mat_specular: torch.Tensor  # (O, 3)
    mat_exponent: torch.Tensor  # (O,)
    mat_ambient: torch.Tensor   # (O, 3)
    mat_ior: torch.Tensor       # (O,)
    mat_samples: torch.Tensor   # (O,) MC sample count as a float weight

    # lights (scene.rs:109-155)
    light_p: torch.Tensor       # (L, 3)
    light_e1: torch.Tensor      # (L, 3)
    light_e2: torch.Tensor      # (L, 3)
    light_color: torch.Tensor   # (L, 3)

    # camera (camera.rs:31-123)
    cam_position: torch.Tensor  # (3,)
    cam_matrix: torch.Tensor    # (3, 3): dir = M @ (x, y, 1)
    cam_focus: torch.Tensor     # () DoF focal distance
    cam_aperture: torch.Tensor  # () DoF aperture radius
    cam_im_dist: torch.Tensor   # () |M @ (0,0,1)|

    # background
    bg_color: torch.Tensor      # (3,) solid color
    bg_cube: torch.Tensor       # (6, H, W, 3) skybox faces, or (6,1,1,3) zeros

    @property
    def dtype(self) -> torch.dtype:
        return self.prim_p.dtype

    @property
    def device(self) -> torch.device:
        return self.prim_p.device

    def to(self, device) -> "SceneData":
        """A copy of every leaf on ``device``."""
        return SceneData(**{f.name: getattr(self, f.name).to(device)
                            for f in dataclasses.fields(self)})


def scene_data_from_numpy(arrays: dict[str, np.ndarray], device,
                          dtype: torch.dtype) -> SceneData:
    """Build a :class:`SceneData` from numpy arrays keyed by field name
    (for example the leaves of the JAX package's scene), cast to
    ``dtype`` on ``device``."""
    names = [f.name for f in dataclasses.fields(SceneData)]
    missing = sorted(set(names) - set(arrays))
    if missing:
        raise KeyError(f"scene arrays lack fields: {missing}")
    return SceneData(**{
        n: torch.tensor(np.asarray(arrays[n])).to(device=device, dtype=dtype)
        for n in names})


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene structure: sizes, type tags, render options."""

    # per-object static tags (tuples => hashable)
    shape_type: tuple[int, ...]   # SHAPE_* per object, -1 for padding
    mat_type: tuple[int, ...]     # MAT_* per object, -1 for padding
    light_type: tuple[int, ...]   # LIGHT_* per light, -1 for padding

    cam_type: int = CAM_SIMPLE_PERSPECTIVE
    cam_samples: int = 1          # camera.rs:26 default 1; DoF: samples
    bg_type: int = BG_SOLID

    # render options (scene.rs:191-198)
    width: int = 800
    height: int = 800
    antialias: int = 1

    # engine constants (raytrace.rs:17-18), overridable per render
    max_depth: int = MAX_DEPTH
    min_significance: float = MIN_SIGNIFICANCE

    # child-ray slots, derived by the builder from the materials present
    has_reflect: bool = True      # any phong/fresnel/transparent specular
    has_refract: bool = False     # any transparent material
    n_indirect: int = 0           # max MC samples over indirect materials

    # static (h, w) of each loaded skybox face (texture.rs:20-24)
    face_sizes: tuple[tuple[int, int], ...] = ((1, 1),) * 6

    @property
    def n_objects(self) -> int:
        return len(self.shape_type)

    @property
    def n_lights(self) -> int:
        return len(self.light_type)

    @property
    def children_per_ray(self) -> int:
        """Static branching factor: child-ray slots per shaded ray."""
        return int(self.has_reflect) + int(self.has_refract) + self.n_indirect

    @property
    def max_live_children(self) -> int:
        """Static bound on live children per lane: the indirect slots
        fire only on IndirectPhong hits and reflect/refract only on the
        other materials, so at most this many are live at once."""
        return max(int(self.has_reflect) + int(self.has_refract),
                   self.n_indirect)

    def live_objects(self) -> list[int]:
        """Indices of the non-padding objects, in scene order."""
        return [i for i, t in enumerate(self.shape_type) if t >= 0]


@dataclasses.dataclass
class Scene:
    """A complete scene: tensor data + static spec."""

    data: SceneData
    spec: SceneSpec
    extras: dict[str, Any] = dataclasses.field(default_factory=dict)
