"""Full-resolution golden comparison of the port on the card: the reference
scene at 800x800 and 1,024 samples per pixel against the reference's
``out.bmp``.

    python3 tools/torch_golden_check.py [spp]

Counterpart of ``tools/golden_check.py``.  Needs the reference snapshot,
``test_scene.txt`` and ``out.bmp``, in ``$RAYTRACE_TPU_REFERENCE_DIR``
(by default ``reference/`` beside the checkout, where the JAX package's
tools and tests look too); the repository does not hold it, and
without it the tool exits 1 saying so: it fetches nothing and makes up
nothing.  Renders the scene twice through the port's CLI on
``--device cuda`` (seeds 0 and 7) and compares the BMPs' bytes: (a) ours
against ``out.bmp``, (b) ours against ours.  The reference's RNG is seeded
from the clock and the scene is lit by Monte-Carlo paths alone, so two
unbiased renders at 1,024 spp differ by their noise: the comparison passes
when (a)'s mean difference is within 10% of (b)'s (noise-limited) and no
cell of an 8x8 grid is biased by 1.5 bytes or more on average.  Prints
the card's name and power limit and one JSON line; exits 0 when both hold.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REFERENCE_DIR = os.environ.get(
    "RAYTRACE_TPU_REFERENCE_DIR",
    os.path.join(os.path.dirname(REPO), "reference"))


def stats(d: np.ndarray) -> dict:
    return {"mean": round(float(d.mean()), 2),
            "p50": int(np.percentile(d, 50)),
            "p99": int(np.percentile(d, 99)), "max": int(d.max())}


def main(spp: int = 1024) -> int:
    scene = os.path.join(REFERENCE_DIR, "test_scene.txt")
    ref_bmp = os.path.join(REFERENCE_DIR, "out.bmp")
    missing = [p for p in (scene, ref_bmp) if not os.path.exists(p)]
    if missing:
        print(f"error: the reference snapshot is not here ({', '.join(missing)}"
              f" missing); set RAYTRACE_TPU_REFERENCE_DIR to the directory "
              f"that holds test_scene.txt and out.bmp", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device: the check renders on the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.io.bmp import read_bmp

    ref = read_bmp(ref_bmp).astype(np.int32)
    images = []
    with tempfile.TemporaryDirectory() as tmp:
        for seed in (0, 7):
            out = os.path.join(tmp, f"seed{seed}.bmp")
            rc = cli.main([scene, "-o", out, "--spp", str(spp), "--seed",
                           str(seed), "--device", "cuda", "-q"])
            if rc != 0:
                print(f"error: the CLI exited {rc}", file=sys.stderr)
                return 1
            images.append(read_bmp(out).astype(np.int32))
    a, b = images
    if a.shape != ref.shape:
        print(f"error: rendered {a.shape}, the reference is {ref.shape}",
              file=sys.stderr)
        return 1
    d_ref, d_own = np.abs(a - ref), np.abs(a - b)
    h, w = ref.shape[:2]
    signed = (a - ref).astype(np.float64)
    regional = signed[:h // 8 * 8, :w // 8 * 8].reshape(
        8, h // 8, 8, w // 8, -1).mean((1, 3, 4))
    out = {"card": cs.nvidia_smi(), "spp": spp,
           "ref_vs_ours_seed0": stats(d_ref),
           "ours_seed0_vs_seed7": stats(d_own),
           "noise_limited": bool(d_ref.mean() < d_own.mean() * 1.10),
           "regional_bias_max_bytes": round(float(np.abs(regional).max()), 3),
           "unbiased": bool(np.abs(regional).max() < 1.5)}
    print(out["card"])
    print(json.dumps(out))
    return 0 if (out["noise_limited"] and out["unbiased"]) else 1


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 1024))
