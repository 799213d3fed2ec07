"""Gradients through the port's CUDA kernels.

The JAX package's Pallas kernels have no backward kernel: each custom
VJP re-runs the plain path under autodiff
(``raytrace_tpu/render/megakernel.py::_radiance_lanes_vjp``,
``raytrace_tpu/ops/intersect_pallas.py::scan_hit``).  :func:`kernel_forward`
is that contract for PyTorch: the forward pass is the kernel, the
backward pass differentiates the kernel's plain PyTorch version on the
saved inputs.
"""

from __future__ import annotations

import torch

from raytrace_tpu_torch.utils.profiling import span


class _KernelForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        out = tuple(kernel(*tensors))
        ctx.mark_non_differentiable(
            *(o for o in out if not o.is_floating_point()))
        return out

    @staticmethod
    def backward(ctx, *cotangents):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors, needs)]
            out = tuple(ctx.plain(*inputs))
            pairs = [(o, c) for o, c in zip(out, cotangents)
                     if o.requires_grad and c is not None]
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(
                [o for o, _ in pairs], wanted, [c for _, c in pairs],
                allow_unused=True) if pairs else [None] * len(wanted))
        return (None, None,
                *(next(grads) if need else None for need in needs))


def kernel_forward(kernel, plain, *tensors, name: str = "kernel",
                   **counts):
    """``kernel(*tensors)``, differentiable through ``plain(*tensors)``,
    under the profiler range ``name`` (the kernel's) while a profiler
    records; ``counts`` (numbers: a launch's ``lanes``) are kept with the
    range's record.

    Both take the same tensors and return a tuple of tensors of the same
    shapes; ``kernel`` launches a CUDA kernel, ``plain`` is its plain
    PyTorch version.  When no tensor requires grad this is just the
    kernel's call.  Otherwise the forward pass is still the kernel, and
    the backward pass re-runs ``plain`` on the saved tensors under
    autograd and pulls the cotangents of the floating-point outputs
    through it; integer and bool outputs take none."""
    with span(name, **counts):
        if not (torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return tuple(kernel(*tensors))
        return _KernelForward.apply(kernel, plain, *tensors)
