"""Procedural scenes: sphere fields of any size.

PyTorch counterpart of :mod:`raytrace_tpu.scene.procedural`: a
Cornell-style box of 5 walls, an emissive dome sphere and ``n`` jittered
spheres on a grid, with one material or a mix of the four.  The same
``np.random.RandomState(seed)`` draws in the same order and the same
``:.3f`` formatting, so the scene text and every scene array equal the
JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.scene.schema import Scene


def sphere_field_source(n_spheres: int, *, width: int = 1024,
                        height: int = 1024, antialias: int = 4,
                        seed: int = 0, mix_materials: bool = True) -> str:
    """The scene-language text of a deterministic n-sphere field inside a
    Cornell-style box (``n_spheres + 6`` objects)."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n_spheres ** (1.0 / 3.0)))
    objs = []
    # box walls (5 planes, matte indirect like the golden scene)
    walls = [
        ((0, 0, -30), (0, 0, 1), (1, 1, 1)),
        ((0, -10, 0), (0, 1, 0), (1, 1, 1)),
        ((0, 30, 0), (0, -1, 0), (1, 1, 1)),
        ((-30, 0, 0), (1, 0, 0), (1, 0.2, 0.2)),
        ((30, 0, 0), (-1, 0, 0), (0.2, 1, 0.2)),
    ]
    for pt, nrm, col in walls:
        objs.append(f"""
        {{ bounds: Plane {{ point: {pt} normal: {nrm} }}
          material: IndirectPhongMaterial {{
            diffuse: rgb{col} specular: rgb(0, 0, 0)
            exponent: 1.0 ambient: rgb(0, 0, 0) samples: 1 }} }}""")
    # emissive dome
    objs.append("""
        { bounds: Sphere { center: (0, 55, 0) radius: 28 }
          material: IndirectPhongMaterial {
            diffuse: rgb(1, 1, 1) specular: rgb(0, 0, 0)
            exponent: 1.0 ambient: rgb(6, 6, 6) samples: 1 } }""")

    kinds = ["IndirectPhongMaterial", "PhongMaterial", "FresnelMaterial",
             "TransparentMaterial"] if mix_materials else [
                 "IndirectPhongMaterial"]
    i = 0
    for gz in range(side):
        for gy in range(side):
            for gx in range(side):
                if i >= n_spheres:
                    break
                cx = (gx - side / 2) * 3.0 + rng.uniform(-0.8, 0.8)
                cy = gy * 2.5 - 8.0 + rng.uniform(-0.6, 0.6)
                cz = -gz * 3.0 - 6.0 + rng.uniform(-0.8, 0.8)
                r = rng.uniform(0.4, 1.0)
                c3 = rng.uniform(0.2, 1.0, 3)
                col = f"({c3[0]:.3f}, {c3[1]:.3f}, {c3[2]:.3f})"
                kind = kinds[i % len(kinds)]
                if kind == "TransparentMaterial":
                    body = ("specular: rgb(0.9, 0.9, 0.9) exponent: 32 "
                            "ior: 1.5")
                elif kind == "FresnelMaterial":
                    body = (f"diffuse: rgb{col} specular: rgb(0.8,0.8,0.8) "
                            f"exponent: 32 ambient: rgb(0,0,0) ior: 1.4")
                elif kind == "PhongMaterial":
                    body = (f"diffuse: rgb{col} specular: rgb(0.1,0.1,0.1) "
                            f"exponent: 16 ambient: rgb(0,0,0)")
                else:
                    body = (f"diffuse: rgb{col} specular: rgb(0,0,0) "
                            f"exponent: 1 ambient: rgb(0,0,0) samples: 1")
                objs.append(f"""
        {{ bounds: Sphere {{ center: ({cx:.3f}, {cy:.3f}, {cz:.3f})
                             radius: {r:.3f} }}
          material: {kind} {{ {body} }} }}""")
                i += 1

    return f"""{{
      objects: [ {''.join(objs)} ]
      lights: [ ]
      camera: SimplePerspectiveCamera new(
          (0, 4, 28), (0, -0.1, -1), (0, 1, 0), 2.2)
      background: SolidColorBackground {{ color: rgb(0.02, 0.02, 0.03) }}
      options: {{ width: {width} height: {height} antialias: {antialias} }}
    }}"""


def make_sphere_field(n_spheres: int, *, device, width: int = 1024,
                      height: int = 1024, antialias: int = 4, seed: int = 0,
                      mix_materials: bool = True,
                      dtype=torch.float32) -> Scene:
    """A deterministic n-sphere scene inside a Cornell-style box, built
    on ``device``."""
    src = sphere_field_source(n_spheres, width=width, height=height,
                              antialias=antialias, seed=seed,
                              mix_materials=mix_materials)
    return build_scene(dsl.parse(src), device=device, dtype=dtype)
