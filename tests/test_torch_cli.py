"""The port's CLI on the CPU: a valid BMP whose sRGB bytes match the JAX
package's render, the errors of flags not ported yet (and the sharded
renders of flags ported since), and the copied logging module."""

import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
from contextlib import redirect_stderr

import jax.numpy as jnp
import numpy as np
import pytest

from raytrace_tpu import color as jax_color
from raytrace_tpu.render.integrator import render_image as jax_render
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu.utils.logging import RenderLog as JaxLog
from raytrace_tpu_torch.io.bmp import read_bmp
from raytrace_tpu_torch.utils.logging import RenderLog

from conftest import REPO_ROOT, repo_path

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))


def _run(args):
    return subprocess.run(
        [sys.executable, "-m", "raytrace_tpu_torch.cli", *args],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)


def test_cli_cpu_bmp_matches_jax(tmp_path):
    out, log = tmp_path / "out.bmp", tmp_path / "log.jsonl"
    r = _run([CORNELL, "-o", str(out), "--width", "8", "--height", "8",
              "--spp", "2", "--seed", "4", "--device", "cpu", "-q",
              "--log-json", str(log)])
    assert r.returncode == 0, r.stderr
    blob = out.read_bytes()
    assert blob[:2] == b"BM" and blob[0x46:0x4A] == b"BGRs"
    assert struct.unpack("<I", blob[10:14])[0] == 122
    assert struct.unpack("<ii", blob[18:26]) == (8, 8)
    assert len(blob) == 122 + 24 * 8
    done = [json.loads(x) for x in log.read_text().splitlines()
            if '"render_done"' in x][-1]
    assert done["nonfinite"] == 0 and done["kernel_launches"] == 0

    js = jax_load(CORNELL, dtype=jnp.float32)
    js = dataclasses.replace(js, spec=dataclasses.replace(js.spec, width=8,
                                                          height=8))
    img = jax_render(js, seed=4, spp=2)
    want = np.asarray(jax_color.to_srgb(jnp.asarray(
        np.clip(img, 0.0, None).astype(np.float32))))
    got = read_bmp(str(out)).astype(int)
    diff = np.abs(got - want.astype(int))
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()
    assert diff.max() <= 2


@pytest.mark.parametrize("flag,item", [(["--shard"], 13),
                                       (["--shard-objects"], 13),
                                       (["--f64", "--device", "cuda"], 12),
                                       (["--profile", "trace"], 5)])
def test_cli_unported_flags(tmp_path, flag, item):
    """``--f64`` on ``--device cuda`` (float64 renders on the CPU, as in
    the reference; item 12) is refused before any device is looked at
    (the last ``--device`` wins).  Item 13's ``--shard`` and
    ``--shard-objects`` and item 5's ``--profile``, refused until they
    were ported, render on ``--device cpu`` the same bytes as the plain
    CLI, and ``--profile`` writes its trace."""
    common = [CORNELL, "--width", "8", "--height", "8", "--spp", "2", "-q",
              "--device", "cpu"]
    # the trace goes into the test's own directory
    flag = [str(tmp_path / f) if f == "trace" else f for f in flag]
    r = _run([*common, "-o", str(tmp_path / "x.bmp"), *flag])
    if item in (5, 13):
        assert r.returncode == 0, r.stderr
        if item == 5:
            assert (tmp_path / "trace" / "trace.json").exists()
        plain = _run([*common, "-o", str(tmp_path / "plain.bmp")])
        assert plain.returncode == 0, plain.stderr
        assert ((tmp_path / "x.bmp").read_bytes()
                == (tmp_path / "plain.bmp").read_bytes())
        return
    assert r.returncode == 2
    assert f"(ROADMAP item {item})" in r.stderr
    assert not (tmp_path / "x.bmp").exists()


def test_cli_f64_cpu_matches_jax_cli_bytes(tmp_path):
    """``--f64 --device cpu`` renders cornell in float64 through the plain
    path; its BMP equals, byte for byte, the JAX package's CLI with
    ``--f64`` (float64 on the CPU there too)."""
    common = [CORNELL, "--width", "16", "--height", "16", "--spp", "2",
              "--seed", "1", "--f64", "-q"]
    ours, theirs = tmp_path / "torch.bmp", tmp_path / "jax.bmp"
    log = tmp_path / "log.jsonl"
    r = _run([*common, "-o", str(ours), "--device", "cpu", "--log-json",
              str(log)])
    assert r.returncode == 0, r.stderr
    done = [json.loads(x) for x in log.read_text().splitlines()
            if '"render_done"' in x][-1]
    assert done["kernel_launches"] == 0 and done["nonfinite"] == 0
    env = dict(os.environ, JAX_ENABLE_X64="1", RAYTRACE_TPU_FORCE_CPU="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-m", "raytrace_tpu.cli", *common,
                        "-o", str(theirs)], cwd=REPO_ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    blob = ours.read_bytes()
    assert len(blob) == 122 + 48 * 16 and any(blob[122:])
    assert blob == theirs.read_bytes()


def test_cli_errors(tmp_path):
    r = _run(["/nonexistent/scene.txt", "-o", str(tmp_path / "x.bmp"),
              "--device", "cpu"])
    assert r.returncode == 1 and "error:" in r.stderr
    # a scene file that does not parse is refused the same way (scenes
    # past 64 objects render: tests/test_torch_large.py)
    bad = tmp_path / "bad.txt"
    bad.write_text("{ objects: [ { bounds: Sphere { center: (0, 0 } ] }")
    r = _run([str(bad), "-o", str(tmp_path / "x.bmp"), "--device", "cpu"])
    assert r.returncode == 1 and "error:" in r.stderr
    assert not (tmp_path / "x.bmp").exists()


def test_cli_cpu_renders_showcase(tmp_path):
    """The showcase (all four materials, three light types, depth of
    field, a 63-node tree per lane) through the CLI on the CPU at a small
    size: a well-formed BMP of finite, lit pixels."""
    out, log = tmp_path / "show.bmp", tmp_path / "log.jsonl"
    r = _run([str(repo_path("examples", "materials_showcase.txt")), "-o",
              str(out), "--width", "16", "--height", "10", "--spp", "2",
              "--device", "cpu", "-q", "--log-json", str(log)])
    assert r.returncode == 0, r.stderr
    blob = out.read_bytes()
    assert blob[:2] == b"BM" and struct.unpack("<ii", blob[18:26]) == (16, 10)
    assert len(blob) == 122 + 48 * 10
    done = [json.loads(x) for x in log.read_text().splitlines()
            if '"render_done"' in x][-1]
    assert done["nonfinite"] == 0 and done["mean_radiance"] > 0
    assert done["kernel_launches"] == 0 and done["primary_samples"] == 1280


def test_logging_copy_prints_the_same(tmp_path):
    outs = []
    for cls, path in ((RenderLog, tmp_path / "a.jsonl"),
                      (JaxLog, tmp_path / "b.jsonl")):
        buf = io.StringIO()
        with redirect_stderr(buf):
            log = cls(json_path=str(path))
            log.event("scene", objects=7, size="8x8")
            with log.phase("encode", path="x.bmp"):
                pass
        recs = [json.loads(x) for x in path.read_text().splitlines()]
        for rec in recs:
            rec.pop("t")
            rec.pop("seconds", None)
        lines = [x.split(" seconds=")[0] for x in buf.getvalue().splitlines()]
        outs.append((lines, recs))
    assert outs[0] == outs[1]
