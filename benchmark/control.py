"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.control --workload golden.final --seeds 11 12 13

For each seed, in one process: the cell's set-up and the requests its
check keeps (no timed window), then the check of the program's output
against the reference (the sound readings), and the same check with the
reference computed in bfloat16 in the program's place (the control, one
precision below the configuration's float32).  A fitting cell also
reads a fault planted in the reference put in the program's place: half
of the pixels left out of the loss, the sum over the rest doubled.  One
JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def forks(cell) -> dict:
    """The look behind a fit's loss gap: the program's first forward (its
    kernel) against the reference's, lane by lane, from the same start:
    the lanes outside K1's rule (|d| <= 1e-4 max(1, |ref|) a channel) and
    the share of the squared-error gap that the ten lanes with the largest
    change carry."""
    from raytrace_tpu_torch.render.integrator import sample_pixels

    with torch.no_grad():
        img = sample_pixels(cell.SceneData(**cell.start), cell.scene.spec,
                            cell.px, cell.py, cell.sample_ids, cell.fit_seed)
        lv = cell.reference.leaves(cell.ref, cell.device, torch.float32)
        for n, d in cell.noise.items():
            lv[n] = lv[n] + torch.as_tensor(d, dtype=torch.float32,
                                            device=cell.device)
        # one sample a pixel over every pixel: the fit's own lanes; float32
        # again, to the bit, since the mean over one sample is exact
        ref = cell.reference.pixel_means(
            cell.ref, lv, cell.py * cell.width + cell.px, 1, cell.fit_seed,
            cell.width, cell.height, cell.bench.config["check_block"]).to(
                torch.float32)
        d = (img - ref).abs()
        out_rule = (d > 1e-4 * torch.clamp(ref.abs(), min=1.0)).any(dim=1)
        sq = ((img - cell.target) ** 2).sum(1) - ((ref - cell.target) ** 2
                                                  ).sum(1)
        top = sq.abs().topk(10).values.sum()
    # a second witness: the program's own plain path, forward and
    # backward, from the same start and seed
    from raytrace_tpu_torch import optim
    from raytrace_tpu_torch.render import megakernel

    from benchmark.reference import fit as ref_fit

    real = megakernel.radiance_lanes
    megakernel.radiance_lanes = megakernel.radiance_lanes_reference
    try:
        _, plain = optim.loss_and_grad(
            cell.SceneData(**cell.start), cell.scene.spec, cell.px, cell.py,
            cell.sample_ids, cell.fit_seed, cell.target, cell.mask)
    finally:
        megakernel.radiance_lanes = real
    names = list(cell.grad0)
    plain = {n: getattr(plain, n) for n in names}
    witness = {"kernel_vs_plain": ref_fit.leaf_gaps(cell.grad0, plain, names)}
    return {"witness": witness, "plain": plain,
            "lanes": int(img.shape[0]), "outside_rule": int(out_rule.sum()),
            "loss_gap_first": float(sq.sum() / ((ref - cell.target) ** 2
                                                ).sum()),
            "top10_share": float(top / sq.abs().sum().clamp(min=1e-30)),
            "largest_d": float(d.max())}


def readings(workload: str, seed: int, device) -> dict:
    from benchmark import manifest
    from benchmark.reference import fit as ref_fit
    from benchmark.trace import Spans

    bench = manifest.load(workload, seed)
    cell = bench.kind(bench, device, Spans())
    t = time.perf_counter()
    cell.setup()
    for _ in range(bench.traffic.get("check_images", 0)):
        cell.request(cell.next_seed())
    look = forks(cell) if bench.traffic["kind"] == "fit" else None
    cell.free()
    out = {"seed": seed, "program_s": time.perf_counter() - t}
    t = time.perf_counter()
    out["sound"] = cell.check()
    out["check_s"] = time.perf_counter() - t
    out["control"] = cell.check(control=torch.bfloat16)
    if bench.traffic["kind"] == "fit":
        half = cell.px.shape[0] // 2
        ref = ref_fit.replay(cell.ref, cell.noise, cell.target, cell.px,
                             cell.py, cell.fit_seed, cell.lr, cell.width,
                             cell.height, torch.float32)
        bad = ref_fit.replay(cell.ref, cell.noise, cell.target[:half],
                             cell.px[:half], cell.py[:half], cell.fit_seed,
                             cell.lr, cell.width, cell.height, torch.float32,
                             loss_scale=2.0)
        out["half_batch"] = ref_fit.compare(bad, ref)
        got = {"grad0": cell.grad0, "change": cell.change}
        look["witness"]["plain_vs_reference"] = ref_fit.leaf_gaps(
            look.pop("plain"), ref["grad0"], list(cell.grad0))
        out["look"] = look
        out["leaves"] = {
            n: [ref_fit._norms({n: got[k][n]})[n] for k in got]
            + [ref_fit._norms({n: ref[k][n]})[n] for k in got]
            for n in cell.grad0}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
