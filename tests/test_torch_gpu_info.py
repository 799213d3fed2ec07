"""The card's figures (``utils/gpu_info.py``) and the kernels' operation
counts and bounds (``utils/flops.py``), on the CPU with an H100's
properties: the fold's staging limit, the published peaks by name, and
the counts and bounds PERF.md states.  Also that the port's tools import
neither JAX nor the JAX package."""

import ast
import dataclasses
import types

import pytest

from raytrace_tpu_torch.ops import intersect_scan
from raytrace_tpu_torch.scene.builder import load_scene_file
from raytrace_tpu_torch.utils import flops, gpu_info

from conftest import REPO_ROOT, repo_path

# what torch.cuda.get_device_properties reports of an H100 SXM
H100 = types.SimpleNamespace(
    name="NVIDIA H100 80GB HBM3", multi_processor_count=132,
    shared_memory_per_multiprocessor=233472,
    shared_memory_per_block_optin=232448, regs_per_multiprocessor=65536,
    max_threads_per_multi_processor=2048, L2_cache_size=52428800)


def test_h100_figures_and_fold_limit():
    card = gpu_info.card(H100)
    assert (card.sm_count, card.shared_per_sm, card.l2_bytes) == (
        132, 233472, 52428800)
    # the scan kernel at 48 registers: five blocks of 256 threads an SM,
    # a fifth of 228 KB less the 1 KB reserved per block, to a whole KB
    assert gpu_info.resident_blocks(card, 48, 256) == 5
    assert gpu_info.fold_shared_max_bytes(card, 48) == 45056
    # at 64 registers (the render kernels' large instances) four blocks
    assert gpu_info.fold_shared_max_bytes(card, 64) == 56 * 1024
    # threads bound a small kernel: eight blocks of 256
    assert gpu_info.resident_blocks(card, 24, 256) == 8


def test_h100_limit_stages_the_same_tables(monkeypatch):
    """1,006 objects (33 chunks, 21.6 KB) are staged in shared memory
    beside the scene's header and 4,006 (127 chunks, 83 KB) are not."""
    monkeypatch.setattr(intersect_scan, "FOLD_SHARED_MAX_BYTES",
                        gpu_info.fold_shared_max_bytes(gpu_info.card(H100),
                                                       48))
    assert intersect_scan.fold_shared_max_bytes() == 45056
    assert intersect_scan.fold_bytes(33) == 21648
    assert intersect_scan.fold_in_shared(33, other_bytes=96)
    assert intersect_scan.fold_bytes(127) == 83312
    assert not intersect_scan.fold_in_shared(127)


def test_peaks_by_name():
    p = gpu_info.peaks(H100)
    assert p is gpu_info.H100_SXM
    assert (p.fp32_flops, p.mem_bytes, p.sm_count) == (67e12, 3.35e12, 132)
    assert "data sheet" in p.source
    assert p.sfu_ops == 132 * 16 * 1.98e9 and p.int_ops == 132 * 64 * 1.98e9
    assert gpu_info.peaks(gpu_info.card(H100)) is p
    for other in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB",
                  dataclasses.replace(gpu_info.card(H100), sm_count=114)):
        with pytest.raises(LookupError):
            gpu_info.peaks(other)
    with pytest.raises(RuntimeError, match="does not report"):
        gpu_info.card(types.SimpleNamespace(name="x"))


def test_counts_and_bounds_as_perf_md_states():
    """The object tests' counts, and the bounds of PERF.md's rows from the
    work its runs counted: K1 on cornell at 1024x1024 (6 nodes a lane,
    all hits) 0.0550 ms by its integer operations; K3 on the showcase
    (3.887 live nodes a lane) 0.0175 ms by its bytes; the scan kernel at
    1,006 objects, as chip_smoke.py counts it."""
    assert (flops.FLOPS_SPHERE, flops.FLOPS_SPHERE_ROW, flops.FLOPS_PLANE,
            flops.FLOPS_BOUND, flops.FLOPS_SKY, flops.SKY_TEXEL_BYTES) == (
                28, 19, 14, 34, 40, 48)
    cornell = load_scene_file(str(repo_path("examples",
                                            "cornell_indirect.txt")),
                              device="cpu")
    spec = dataclasses.replace(cornell.spec, width=1024, height=1024)
    work = {"visits": 6.0, "hits": 6.0, "last_hits": 1.0, "misses": 0.0}
    assert list(flops.k1_lane_ops(spec, work)) == [1145, 57, 439]
    ms, by, units = flops.k1_bound(spec, 1 << 21, work)
    assert by == "operations" and max(units, key=units.get) == "int32"
    assert round(ms, 4) == 0.0550
    show = load_scene_file(str(repo_path("examples",
                                         "materials_showcase.txt")),
                           device="cpu")
    ms, by = flops.render_bound(show.spec, 1 << 21,
                                {"visits": 3.887, "misses": 0.0})
    assert (round(ms, 4), by) == (0.0175, "bytes")
    fl, nb = flops.scan_counts(1 << 21, 15.47, 32, 5, 33 * 32)
    assert nb == 33 * (1 << 21) + 20 * 33 * 32
    assert fl == (1 << 21) * (15.47 * 32 * 19 + 32 * 34 + 5 * 14)
    assert flops.bound(67e9, 0.0) == (1.0, "operations")
    assert flops.bound(0.0, 3.35e9) == (1.0, "bytes")


def test_port_tools_import_no_jax():
    """The port's tools and chip_smoke.py import neither JAX nor the JAX
    package (they run where JAX may not be)."""
    paths = sorted((REPO_ROOT / "tools").glob("torch_*.py")) + [
        REPO_ROOT / "chip_smoke.py"]
    assert len(paths) >= 4
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "raytrace_tpu", "bench"), (path, name)


def test_tools_refuse_without_their_inputs(tmp_path):
    """The golden check fails where the reference snapshot is not (and
    where there is no card): it neither falls back to the CPU nor makes
    anything up."""
    import os
    import subprocess
    import sys

    env = {**os.environ, "RAYTRACE_TPU_REFERENCE_DIR": str(tmp_path),
           "CUDA_VISIBLE_DEVICES": ""}
    r = subprocess.run([sys.executable, "tools/torch_golden_check.py"],
                       cwd=REPO_ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 1 and "reference snapshot" in r.stderr, r.stderr
    assert r.stdout == ""
