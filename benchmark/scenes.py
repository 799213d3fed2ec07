"""The text of a configuration's scene, which the port and the reference
both read.

A configuration names a scene file beside it (``scene_file``) or a
generator (``generator``) with its arguments.  ``sphere_field`` is a
frozen copy of ``raytrace_tpu_torch/scene/procedural.py::
sphere_field_source`` at commit 6033020 (``BASELINE.json`` configs[3]'s
field: a Cornell-style box, an emissive dome and ``n`` jittered spheres
on a grid, the same ``RandomState`` draws and ``:.3f`` numbers);
``benchmark/tests/test_harness_yardstick.py`` pins it to the original.
"""

from __future__ import annotations

import os

import numpy as np


def sphere_field(n_spheres: int, *, width: int = 1024, height: int = 1024,
                 antialias: int = 4, seed: int = 0,
                 mix_materials: bool = True) -> str:
    """The scene text of an ``n_spheres`` field (``n_spheres + 6``
    objects)."""
    rng = np.random.RandomState(seed)
    side = int(np.ceil(n_spheres ** (1.0 / 3.0)))
    objs = []
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


GENERATORS = {"sphere_field": sphere_field}


def scene_text(config: dict, config_dir: str) -> str:
    """The scene text of a configuration: its scene file, read from beside
    its own file, or its generator's output."""
    scene = config["scene"]
    if "scene_file" in scene:
        with open(os.path.join(config_dir, scene["scene_file"])) as f:
            return f.read()
    args = dict(scene["args"])
    return GENERATORS[scene["generator"]](**args)
