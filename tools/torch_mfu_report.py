"""Per-regime launch time of the port's kernels beside their operation
counts and bounds.

    python3 tools/torch_mfu_report.py [regime ...]

Counterpart of ``tools/mfu_report.py``.  Runs on one NVIDIA GPU and fails
without one.  For each regime: the marginal ms per launch of 2,097,152
lanes (or rays), by the chain slope of ``raytrace_tpu_torch/bench.py::
measure_slope`` (chains of 2, 4 and 8 launches, CUDA events, medians of
five runs, least squares); the FP32 operations and the bytes per lane
that ``raytrace_tpu_torch/utils/flops.py`` counts for the work the
launch's paths need (``render/work.py::path_work`` on 512 of its warps);
and the launch's share of its bound (the least time the card could take
for that work, at the published peaks of ``utils/gpu_info.py``), with
what bounds it.  The regimes:

  cornell       K1, cornell_indirect at 1024x1024, 16 spp, pixel-ordered
  showcase      K3, materials_showcase, random lanes
  field_linear  K1-large, the 1,006-object linear field, 1024x1024 x 2
  field_mixed   K3-large, the 1,006-object mixed field, 1024x1024 x 2
  k5            the scan kernel on the linear field's 2,097,152 camera rays

Prints the card's name and power limit, then one JSON line per regime.
"""

from __future__ import annotations

import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REGIMES = ("cornell", "showcase", "field_linear", "field_mixed", "k5")
N = 1 << 21


def regime_launch(name: str, device):
    """(kernel name, one launch of the regime as a function of its seed,
    lanes or rays, FP32 operations, bytes, bound) for ``name``."""
    import dataclasses

    import chip_smoke as cs
    from raytrace_tpu_torch.ops import intersect_scan
    from raytrace_tpu_torch.ops.intersect import scene_tables
    from raytrace_tpu_torch.ops.vec import V3
    from raytrace_tpu_torch.render import megakernel
    from raytrace_tpu_torch.render.integrator import primary_rays
    from raytrace_tpu_torch.render.work import path_work, warp_sample
    from raytrace_tpu_torch.scene.builder import load_scene_file
    from raytrace_tpu_torch.scene.procedural import make_sphere_field
    from raytrace_tpu_torch.utils import flops

    tables = None
    if name == "cornell":
        sc = load_scene_file(cs.SCENE, device=device)
        spec = dataclasses.replace(sc.spec, width=1024, height=1024)
        lanes = cs.pixel_lanes(1024, N // 16, 16, 1, device)
    elif name == "showcase":
        sc = load_scene_file(cs.SHOWCASE, device=device)
        spec = sc.spec
        lanes = cs.random_lanes(spec, N, cs.SEED, device)
    else:
        sc = make_sphere_field(1000, mix_materials=name == "field_mixed",
                               device=device)
        spec = sc.spec
        tables = scene_tables(sc.data, spec)
        lanes = cs.pixel_lanes(1024, N // 2, 2, 1, device)
    lanes = [t.to(torch.int32) for t in lanes]
    if name == "k5":
        ro, rd, _, _ = primary_rays(sc.data, spec, *lanes, 0)
        sample = [V3(*(warp_sample(c) for c in v)) for v in (ro, rd)]
        entered = float(intersect_scan.scan_hit_reference(
            tables.table, tables.ids, tables.n_sph_pad, *sample,
            tables.bounds, return_entered=True)[3].float().mean())
        n_planes = sum(t == 1 for t in spec.shape_type)
        fl, nb = flops.scan_counts(N, entered, tables.n_sph_pad // 32,
                                   n_planes, tables.table.shape[0])

        def launch(seed):
            return intersect_scan.scan_hit(tables.table, tables.ids,
                                           tables.n_sph_pad, ro, rd,
                                           tables.bounds)[0]

        return (megakernel.KERNEL_SCAN, launch, N, fl, nb,
                flops.bound(fl, nb), {"chunks_entered": entered})
    work = path_work(sc.data, spec, [warp_sample(t) for t in lanes], 0)
    fl, nb = flops.render_counts(spec, N, work, tables)
    if name == "cornell":
        b_ms, b_by, units = flops.k1_bound(spec, N, work)
        bnd = (b_ms, f"{b_by} ({max(units, key=units.get)})")
    else:
        bnd = flops.bound(fl, nb)

    def launch(seed):
        return megakernel.radiance_lanes(sc.data, spec, *lanes, seed).x

    need = {"live_nodes": work["visits"], "warp_nodes": work["warp_visits"]}
    if tables is not None:
        need["chunks_entered"] = work["chunks"]
    return megakernel.kernel_for(spec), launch, N, fl, nb, bnd, need


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or list(REGIMES)
    unknown = [n for n in names if n not in REGIMES]
    if unknown:
        print(f"error: unknown regime {unknown}; the regimes: {REGIMES}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("error: no CUDA device: the report measures the card",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from raytrace_tpu_torch.bench import measure_slope

    device = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    print(smi)
    for name in names:
        kernel, launch, n, fl, nb, (b_ms, b_by), need = regime_launch(
            name, device)

        def chain(k, bias):
            for i in range(k):
                out = launch(bias + i)
            return out

        slope, fixed, _, busy = measure_slope(chain, ks=(2, 4, 8))
        print(json.dumps({
            "regime": name, "kernel": kernel, "lanes_per_launch": n,
            "launch_ms": slope, "fixed_ms": fixed, "device_busy": busy,
            "fp32_ops_per_lane": fl / n, "bytes_per_lane": nb / n,
            "needs": need, "bound_ms": b_ms, "bound_by": b_by,
            "share_of_bound": b_ms / slope,
            "fp32_share_of_peak": fl / (slope * 1e-3) / cs.H100_SXM.fp32_flops,
            "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
