"""raytrace_tpu_torch: the raytracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``raytrace_tpu``, which stays the reference it
is tested against.  Same layout: ``scene/`` (DSL, schema, builder),
``ops/`` (vectors, RNG, intersection, kernel build), ``models/``
(camera, background, materials), ``render/`` (integrator, megakernel),
``io/`` (BMP), ``utils/``, ``color.py`` and ``cli.py``.  Importing the
package imports no submodule and builds no kernel.
"""
