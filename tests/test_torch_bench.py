"""The port's benchmark harness (``raytrace_tpu_torch/bench.py``) on the
CPU: its ray counts against ``bench.py``'s formulas on the JAX package's
spec of the same scene, the chain-slope fit, the chain's sum, each mode's
JSON line with ``bench.py``'s keys, the refusal of ``--device cuda``
without a card, and ``--shard`` over a gloo group of two ranks."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render.integrator import tree_nodes as jax_tree_nodes
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch import bench
from raytrace_tpu_torch.render.integrator import sample_pixels
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load
from raytrace_tpu_torch.scene.procedural import make_sphere_field

from conftest import REPO_ROOT, repo_path
from test_torch_group import bench_shard_job, run_group

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))

# bench.py's keys, by mode (bench.py:191-201, :204-211, :253-265)
DEFAULT_KEYS = {"metric", "value", "unit", "vs_baseline", "per_launch_ms",
                "fixed_overhead_ms"}
LARGE_KEYS = {"metric", "value", "unit", "vs_baseline", "fused_launch_ms",
              "split_launch_ms", "speedup_fused_over_split",
              "obj_tests_per_sec_fused"}
SHARD_KEYS = {"metric", "value", "unit", "vs_baseline",
              "efficiency_vs_backend_ceiling", "n_devices", "backend",
              "rays_per_sec_per_device", "rays_per_sec_total",
              "single_device_launch_ms", "sharded_launch_ms"}
# a small run: 256 lanes (16 pixels of 16 samples), short chains
SMALL = ["--device", "cpu", "--lanes", "256"]
KS, REPS = (1, 3), 3


def _jax_counts(spec, n_pix, n_s):
    """bench.py's formulas (:155, :180-189) on a JAX spec."""
    levels = spec.max_depth + 2
    return {"primary": n_pix * n_s * spec.cam_samples, "levels": levels,
            "rounds": (jax_tree_nodes(spec) if spec.children_per_ray > 1
                       else levels),
            "objects": sum(1 for t in spec.shape_type if t >= 0)}


@pytest.mark.parametrize("scene", ["cornell", "field_mixed_100"])
def test_ray_counts_match_bench_formulas(scene):
    n_pix = bench.LANES["cuda"] // bench.SAMPLES
    if scene == "cornell":
        js, ts = (jax_load(CORNELL, dtype=jnp.float32),
                  torch_load(CORNELL, device="cpu"))
    else:
        js, ts = (jax_field(100, mix_materials=True),
                  make_sphere_field(100, mix_materials=True, device="cpu"))
    got = bench.ray_counts(ts.spec, n_pix, bench.SAMPLES)
    assert got == _jax_counts(js.spec, n_pix, bench.SAMPLES)
    if scene == "cornell":
        assert got["primary"] == 1 << 21 and got["rounds"] == got["levels"]
    else:
        assert ts.spec.children_per_ray > 1 and got["objects"] == 106
        assert got["rounds"] > got["levels"]


def test_measure_slope_recovers_a_known_line(monkeypatch):
    """A chain whose call takes 0.25 ms a launch plus 1.5 ms on a fake
    clock: the fit gives both back; the warm-up lasts WARM_S; every timed
    call has a bias of its own, and the chain lengths interleave."""
    clock = [0.0]
    calls = []

    def chain(k, bias):
        calls.append((k, bias))
        clock[0] += (0.25 * k + 1.5) / 1e3
        return torch.zeros(1)

    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock[0])
    got = bench.measure_slope(chain, ks=(4, 16, 64), reps=3)
    assert got.per_launch_ms == pytest.approx(0.25, abs=1e-9)
    assert got.fixed_ms == pytest.approx(1.5, abs=1e-9)
    assert got.device_busy is None
    assert {k: len(v) for k, v in got.times_ms.items()} == {4: 3, 16: 3,
                                                            64: 3}
    # the warm-up: a call of each length, then the longest until WARM_S of
    # the clock went by
    warm, timed = calls[:-9], calls[-9:]
    assert warm[:3] == [(4, 0), (16, 0), (64, 0)]
    assert set(warm[3:]) == {(64, 0)}
    assert sum(0.25 * k + 1.5 for k, _ in warm) / 1e3 >= bench.WARM_S
    assert sum(0.25 * k + 1.5 for k, _ in warm[:-1]) / 1e3 < bench.WARM_S
    assert [k for k, _ in timed] == [4, 16, 64] * 3
    assert len({b for _, b in timed}) == len(timed)
    assert all(b > 0 for _, b in timed)


def test_chain_sums_shifted_launches():
    """A chain of k = 3 is the sum of three sample_pixels outputs on px
    shifted by bias + i (mod the width)."""
    sc = torch_load(CORNELL, device="cpu")
    spec = sc.spec
    px, py = bench.pixels(6, "cpu", first=spec.width - 3)
    sids = torch.arange(2, dtype=torch.int64)
    got = bench.make_chain(sc.data, spec, px, py, sids)(3, 7)
    want = sum(sample_pixels(sc.data, spec, (px + 7 + i) % spec.width, py,
                             sids, 0).sum() for i in range(3))
    assert got.shape == (1,)
    torch.testing.assert_close(got[0], want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mode", ["default", "large", "large_mix"])
def test_main_prints_one_line_with_bench_keys(mode, capsys):
    argv = {"default": [], "large": ["--large", "100"],
            "large_mix": ["--large", "100", "--mix"]}[mode]
    assert bench.main(SMALL + argv, ks=KS, reps=REPS) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["card"] == "cpu"
    for k, v in line.items():
        assert v is None or isinstance(v, str) or np.isfinite(v), (k, v)
    assert line["value"] > 0
    if mode == "default":
        assert DEFAULT_KEYS <= set(line)
        assert line["metric"] == "rays_per_sec_per_chip_1024sq_depth4"
        assert line["scene"] == "cornell_indirect.txt"
        assert line["device_busy"] is None
        # 16 pixels x 16 samples x 6 rounds a launch
        rays_per_s = 16 * 16 * 6 / line["per_launch_ms"] * 1e3
        assert line["value"] == round(rays_per_s)
        assert line["vs_baseline"] == pytest.approx(
            rays_per_s / bench.REF_CPU_RAYS_PER_SEC)
    else:
        mix = mode == "large_mix"
        assert LARGE_KEYS <= set(line)
        n_obj = _jax_counts(jax_field(100, mix_materials=mix).spec, 1,
                            1)["objects"]
        assert line["metric"] == (f"large_scene_fused_vs_split_{n_obj}obj_"
                                  f"{'mix' if mix else 'linear'}")
        assert line["speedup_fused_over_split"] == pytest.approx(
            line["split_launch_ms"] / line["fused_launch_ms"])


@pytest.mark.parametrize("module", ["bench", "entry"])
def test_cuda_without_a_card_exits_1(module):
    """``--device cuda`` (the default) where PyTorch sees no card: exit 1
    with an error, and no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", f"raytrace_tpu_torch.{module}",
                        "--device", "cuda"], cwd=str(REPO_ROOT), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1, r.stderr
    assert r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_shard_over_two_gloo_ranks(tmp_path):
    got = run_group(bench_shard_job, 2, SMALL + ["--shard"], KS, REPS,
                    out_dir=tmp_path)
    assert [rc for rc, _ in got] == [0, 0]
    assert got[1][1] == ""
    lines = got[0][1].strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert SHARD_KEYS <= set(line)
    assert line["metric"] == "scaling_efficiency_weak_2dev"
    assert line["n_devices"] == 2 and line["backend"] == "cpu"
    # two ranks on one host: the ceiling is 1/2
    assert line["efficiency_vs_backend_ceiling"] == pytest.approx(
        2 * line["value"])
    assert line["rays_per_sec_total"] == pytest.approx(
        2 * line["rays_per_sec_per_device"], abs=1)
