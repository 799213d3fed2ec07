"""Differentiable / inverse rendering: fit scene parameters to images.

PyTorch counterpart of :mod:`raytrace_tpu.optim`.  The gradient of any
image loss flows into every float leaf of ``SceneData``: sphere centers
and radii, plane points and normals, material colors, exponents and ior,
light positions and colors, camera parameters, the background color and
the skybox texels.  Hit *selection* is integral and contributes a zero
subgradient at visibility silhouettes; ``t`` and normals are recomputed
from the winning object's parameters, so geometry gradients flow.

On CUDA tensors a float32 step runs forward through the CUDA megakernel
and backward through its plain PyTorch version
(:mod:`raytrace_tpu_torch.ops.kernel_grad`); the seed is a Python int, so
varying it per step costs nothing.  A float64 scene on CPU tensors takes
the plain version both ways; on CUDA tensors it raises (the kernels are
float32).  :func:`make_sharded_step` shards the pixels over the ranks of
a :class:`raytrace_tpu_torch.parallel.mesh.Mesh` and all-reduces the
loss and the gradients (the data-parallel gradient sync).
"""

from __future__ import annotations

import dataclasses

import torch

from raytrace_tpu_torch.render.integrator import sample_pixels
from raytrace_tpu_torch.scene.schema import SceneData, SceneSpec
from raytrace_tpu_torch.utils.profiling import GRAD_PSUM, span


def render_loss(data: SceneData, spec: SceneSpec, px, py, sample_ids,
                seed: int, target) -> torch.Tensor:
    """Summed squared error between rendered pixels and target (P, 3)."""
    img = sample_pixels(data, spec, px, py, sample_ids, seed)
    return torch.sum((img - target) ** 2)


def _leaves(data: SceneData) -> dict[str, torch.Tensor]:
    return {f.name: getattr(data, f.name) for f in dataclasses.fields(data)}


def loss_and_grad(data: SceneData, spec: SceneSpec, px, py, sample_ids,
                  seed: int, target, trainable: SceneData | None = None):
    """The render loss and its gradient with respect to ``SceneData``: a
    ``SceneData`` of gradients, zeros where a leaf took none.  With
    ``trainable`` (a ``SceneData`` of bools) only the leaves it marks are
    differentiated, which spares the backward pass the others."""
    wanted = {n: t.is_floating_point()
              and (trainable is None or bool(getattr(trainable, n)))
              for n, t in _leaves(data).items()}
    leaves = {n: t.detach().requires_grad_(wanted[n])
              for n, t in _leaves(data).items()}
    loss = render_loss(SceneData(**leaves), spec, px, py, sample_ids, seed,
                       target)
    names = [n for n in leaves if wanted[n]]
    grads = dict(zip(names, torch.autograd.grad(
        loss, [leaves[n] for n in names], allow_unused=True)))
    return loss.detach(), SceneData(**{
        n: grads[n] if grads.get(n) is not None else torch.zeros_like(t)
        for n, t in leaves.items()})


def make_sharded_step(spec: SceneSpec, mesh, seed: int,
                      trainable: SceneData | None = None):
    """A training step with the pixels sharded over ``mesh``'s ranks.

    The returned ``step(data, px, py, sample_ids, target)`` takes the whole
    pixel set (its count divisible by the ranks) and the replicated scene;
    each rank runs :func:`loss_and_grad` on its contiguous shard of the
    pixels and target rows, then the loss and every gradient leaf are
    summed over the ranks.  The loss is a sum over pixels, so every rank
    ends with the single-device step's loss and gradients (up to the order
    of the sum).  In the reference the replicated input's cotangent is
    summed implicitly; here the all-reduce is explicit."""
    from raytrace_tpu_torch.parallel.mesh import all_reduce_sum_

    def step(data: SceneData, px, py, sample_ids, target):
        n, k = px.shape[0], mesh.ranks
        if n % k:
            raise ValueError(f"{n} pixels do not split over {k} ranks")
        lo, hi = mesh.rank * n // k, (mesh.rank + 1) * n // k
        loss, grads = loss_and_grad(data, spec, px[lo:hi], py[lo:hi],
                                    sample_ids, seed, target[lo:hi],
                                    trainable)
        with span(GRAD_PSUM):
            all_reduce_sum_(loss, mesh)
            for g in _leaves(grads).values():
                all_reduce_sum_(g, mesh)
        return loss, grads

    return step


def fit(data: SceneData, spec: SceneSpec, px, py, target, *,
        seed: int = 0, steps: int = 100, learning_rate: float = 1e-2,
        spp: int = 4, optimizer=None, trainable: SceneData | None = None,
        callback=None, vary_seed: bool = True):
    """Gradient-descent scene fitting (inverse rendering) with Adam.

    ``trainable``: optional ``SceneData`` of bools marking which leaves
    to update; default: every float leaf.  ``optimizer``: a function from
    the list of trained tensors to a ``torch.optim.Optimizer`` (default:
    ``torch.optim.Adam`` with ``learning_rate``).  ``vary_seed``
    re-randomizes the Monte-Carlo sampler each step (stochastic
    gradients; avoids fitting to sampler noise); turn it off when the
    target was rendered with the same seed and exact convergence is
    wanted.  Returns the fitted ``SceneData`` and the loss history."""
    leaves = {n: t.detach().clone() for n, t in _leaves(data).items()}
    trained = [n for n, t in leaves.items() if t.is_floating_point()
               and (trainable is None or bool(getattr(trainable, n)))]
    mask = SceneData(**{n: n in trained for n in leaves})
    params = [leaves[n] for n in trained]
    opt = (optimizer(params) if optimizer is not None
           else torch.optim.Adam(params, lr=learning_rate))
    sample_ids = torch.arange(spp, dtype=torch.int64, device=px.device)

    history = []
    for i in range(steps):
        current = SceneData(**leaves)
        loss, grads = loss_and_grad(current, spec, px, py, sample_ids,
                                    seed + i if vary_seed else seed, target,
                                    mask)
        for n in trained:
            leaves[n].grad = getattr(grads, n)
        opt.step()
        history.append(float(loss))
        if callback is not None:
            callback(i, history[-1], SceneData(**leaves))
    return SceneData(**leaves), history
