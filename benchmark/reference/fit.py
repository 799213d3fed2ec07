"""The reference's fitting steps, and the numbers that hold a fit to them.

A step is the squared error of the rendered pixels (one sample each) to
the target, its gradient in every float leaf by autograd through
:mod:`benchmark.reference.render`, and Adam's update (Kingma and Ba,
betas 0.9 and 0.999, eps 1e-8, bias-corrected), written out here.  The
fit starts from the scene perturbed by ``perturbation`` (drawn from the
run's seed, handed to the program too), and the seed of step ``i`` is
the fit's seed plus ``i``.

:func:`compare` reads three numbers: the first three steps' losses (the
worst step), the first step's gradient (the worst leaf) and the leaves'
change over the three steps (the median leaf), each leaf's gap of norms
over the larger of that leaf's reference norm and the median leaf's.
The change leaves out the leaves whose reference gradient lies under a
thousandth of the median leaf's: Adam moves those by round-off alone.
It is read at the median leaf because the worst leaf's swings from seed
to seed with the few lanes that the program's kernel forks (PERF.md).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import render as ref_render
from benchmark.reference.scene import RefScene

STEPS = 3
BETAS, EPS = (0.9, 0.999), 1e-8


def perturbation(scene: RefScene, rng: np.random.Generator,
                 scale: dict) -> dict:
    """Seeded offsets of the scene's leaves: ``scale[name]`` times a
    standard normal draw for each element of that leaf."""
    return {name: rng.standard_normal(np.shape(scene.arrays[name])) * s
            for name, s in sorted(scale.items())}


def replay(scene: RefScene, noise: dict, target, px, py, seed: int,
           lr: float, width: int, height: int, dtype,
           loss_scale: float = 1.0) -> dict:
    """The reference's first :data:`STEPS` steps: ``losses``, ``grad0``
    (the first step's gradient) and ``change`` (the leaves' change over
    the steps), each leaf as a tensor.  ``loss_scale`` multiplies the loss
    (a planted fault's: half the pixels, their sum doubled)."""
    lv = ref_render.leaves(scene, px.device, dtype)
    for name, delta in noise.items():
        lv[name] = lv[name] + torch.as_tensor(delta, dtype=dtype,
                                              device=px.device)
    names = list(lv)
    start = {n: lv[n].detach().clone() for n in names}
    m = {n: torch.zeros_like(lv[n]) for n in names}
    v = {n: torch.zeros_like(lv[n]) for n in names}
    aa = torch.zeros_like(px)
    losses, grad0 = [], None
    for i in range(STEPS):
        params = {n: lv[n].detach().requires_grad_(True) for n in names}
        rad = ref_render.chain(scene, params, px, py, aa, seed + i, width,
                               height)
        loss = torch.sum((rad - target.to(dtype)) ** 2) * loss_scale
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = {n: g if g is not None else torch.zeros_like(lv[n])
                 for n, g in zip(names, grads)}
        losses.append(float(loss.detach()))
        if i == 0:
            grad0 = grads
        t = i + 1
        for n in names:
            m[n] = BETAS[0] * m[n] + (1 - BETAS[0]) * grads[n]
            v[n] = BETAS[1] * v[n] + (1 - BETAS[1]) * grads[n] * grads[n]
            m_hat = m[n] / (1 - BETAS[0] ** t)
            v_hat = v[n] / (1 - BETAS[1] ** t)
            lv[n] = lv[n].detach() - lr * m_hat / (torch.sqrt(v_hat) + EPS)
        del rad, loss, params
    return {"losses": losses, "grad0": grad0,
            "change": {n: lv[n] - start[n] for n in names}}


def _norms(leaves: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double())) for n, t in
            leaves.items()}


def leaf_gaps(got: dict, want: dict, names) -> dict:
    """Each leaf's gap of its norm to the reference's, over the larger of
    that leaf's reference norm and the median of the leaves' that are not
    zero; a gap that is not a finite number is infinite."""
    g, w = _norms(got), _norms(want)
    nonzero = [w[n] for n in names if w[n] > 0]
    median = float(np.median(nonzero)) if nonzero else 0.0
    return {n: _worst([abs(g[n] - w[n]) / max(w[n], median)])
            for n in names if max(w[n], median) > 0}


def _worst(gaps) -> float:
    """The largest gap; a gap that is not a finite number is infinite."""
    return max((g if math.isfinite(g) else math.inf for g in gaps),
               default=0.0)


def compare(got: dict, want: dict) -> dict:
    """``loss_gap``, ``grad_gap`` and ``change_gap`` of a fit's first steps
    (``got``) against the reference's (``want``)."""
    loss_gap = _worst(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                          want["losses"]))
    names = [n for n in want["grad0"] if n in got["grad0"]]
    g = _norms(want["grad0"])
    median = float(np.median([g[n] for n in names if g[n] > 0]))
    moved = [n for n in names if g[n] >= 1e-3 * median]
    change = list(leaf_gaps(got["change"], want["change"], moved).values())
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(leaf_gaps(got["grad0"], want["grad0"],
                                         names).values()),
            "change_gap": float(np.median(change)) if change else 0.0}
