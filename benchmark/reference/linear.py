"""The reference of linear IndirectPhong scenes, under the interface that
:mod:`benchmark.manifest` resolves a configuration's reference to.

A configuration that names no ``reference`` gets this one.  Each function
wraps the plain renderer (:mod:`benchmark.reference.render`), its scene
reader (:mod:`benchmark.reference.scene`, which refuses lights, every
material but IndirectPhong with one sample, every camera but
``SimplePerspectiveCamera new`` and every background but a solid one) and
the yardstick's counts of its paths (:mod:`benchmark.yardstick.work`).
"""

from __future__ import annotations

from benchmark.reference import render, scene as ref_scene
from benchmark.yardstick import counts, work as ref_work


def parse(text: str) -> ref_scene.RefScene:
    return ref_scene.parse(text)


def leaves(scene, device, dtype) -> dict:
    return render.leaves(scene, device, dtype)


def pixel_means(scene, leaves, pixels, spp: int, seed: int, width: int,
                height: int, lanes_per_block: int):
    return render.pixel_means(scene, leaves, pixels, spp, seed, width,
                              height, lanes_per_block)


def request_rays(scene, width: int, height: int, spp: int) -> int:
    """Closest-hit rounds of one request: a linear chain takes
    ``max_depth + 2`` a primary sample."""
    rays = counts.ray_counts(spec(scene), width * height, spp)
    return rays["primary"] * rays["rounds"]


def spec(scene):
    return ref_work.ref_spec(scene)


def n_objects(scene) -> int:
    return scene.n_objects


def work(scene, leaves, lanes, seed: int, width: int, height: int,
         large: bool) -> dict:
    return ref_work.path_work(scene, leaves, lanes, seed, width, height,
                              large)
