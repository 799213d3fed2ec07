"""Inverse rendering demo of the PyTorch port: recover scene appearance
by gradient descent.

Renders ``examples/cornell_indirect.txt`` at 48x48 with 8 samples per
pixel as the target, perturbs the diffuse sphere's color and the emitter
sphere's brightness, then fits both back with Adam through the gradient
of the photometric loss: the whole integrator (6 levels of closest hit
and shading, Monte-Carlo indirect lighting included) is differentiated
end to end.  On ``--device cuda`` every step renders forward through the
CUDA megakernel and differentiates its plain PyTorch version backward.

Geometry leaves (centers, radii, plane parameters) take gradients too
(tests/test_torch_grad.py checks them against finite differences), but
silhouette coverage is a discrete event with a zero subgradient, so the
demo fits the smooth appearance parameters, the well-posed problem.

    python examples/fit_demo_torch.py [steps] [--device {cuda,cpu}]
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCENE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "cornell_indirect.txt")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="?", type=int, default=60)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from raytrace_tpu_torch.optim import fit, loss_and_grad
    from raytrace_tpu_torch.render.integrator import sample_pixels
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.schema import SceneData

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but PyTorch sees no CUDA device",
              file=sys.stderr)
        return 1
    device = torch.device(args.device)
    sc = load_scene_file(SCENE, device=device)
    spec = dataclasses.replace(sc.spec, width=48, height=48)

    pix = torch.arange(spec.width * spec.height, device=device)
    px, py = pix % spec.width, pix // spec.width
    sids = torch.arange(8, device=device)

    # target: the true scene, rendered with a fixed seed
    data = sc.data
    target = sample_pixels(data, spec, px, py, sids, 0)

    # perturb the diffuse sphere's color (object 5) and the emitter's
    # brightness (object 6's ambient)
    diff, amb = data.mat_diffuse.clone(), data.mat_ambient.clone()
    diff[5] = torch.tensor([0.2, 0.6, 0.7], device=device)
    amb[6] *= 0.5
    perturbed = dataclasses.replace(data, mat_diffuse=diff, mat_ambient=amb)

    # fit only the appearance leaves (see the module docstring)
    mask = SceneData(**{f.name: f.name in ("mat_diffuse", "mat_ambient")
                        for f in dataclasses.fields(SceneData)})
    loss0 = float(loss_and_grad(perturbed, spec, px, py, sids, 0, target,
                                mask)[0])

    def cb(i, loss, _):
        if i % 10 == 0:
            print(f"step {i:4d}  loss {loss:.4f}")

    # vary_seed=False: the target uses seed 0, so the loss is an exact
    # deterministic function with minimum 0 at the true parameters
    fitted, hist = fit(perturbed, spec, px, py, target, steps=args.steps,
                       learning_rate=5e-2, spp=8, seed=0, trainable=mask,
                       vary_seed=False, callback=cb)

    print(f"\nloss: {loss0:.4f} -> {hist[-1]:.4f} "
          f"({loss0 / max(hist[-1], 1e-9):.0f}x) on {device}")
    print("diffuse color err:",
          float((fitted.mat_diffuse[5] - data.mat_diffuse[5]).abs().max()))
    print("emitter ambient err:",
          float((fitted.mat_ambient[6] - data.mat_ambient[6]).abs().max()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
