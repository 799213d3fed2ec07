"""raytrace_tpu_torch: the raytracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``raytrace_tpu``, which stays the reference it
is tested against.  Same layout: ``scene/`` (DSL, schema, builder),
``ops/`` (vectors, RNG, intersection, kernel build), ``models/``
(camera, background, materials), ``render/`` (integrator, megakernel),
``io/`` (BMP), ``parallel/`` (ranks, sharded and multi-process
renders, the object ring), ``utils/``, ``color.py`` and ``cli.py``.
Importing the package imports no submodule and builds no kernel.
"""

__version__ = "0.1.0"

# the root's names, as the JAX package exports them: each imported on
# first use, so that importing the package imports no submodule
_EXPORTS = {
    "SceneData": "raytrace_tpu_torch.scene.schema",
    "SceneSpec": "raytrace_tpu_torch.scene.schema",
    "Scene": "raytrace_tpu_torch.scene.schema",
    "deserialize": "raytrace_tpu_torch.scene.dsl",
    "SceneSyntaxError": "raytrace_tpu_torch.scene.dsl",
}

__all__ = ["__version__", *_EXPORTS]


def __getattr__(name: str):
    if name in _EXPORTS:
        import importlib
        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
