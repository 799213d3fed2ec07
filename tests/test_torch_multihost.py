"""Multi-process rendering of the port (``raytrace_tpu_torch.parallel.
multihost`` and the CLI's multi-process branch): twins of
tests/test_multihost.py on ``examples/cornell_indirect.txt`` and, where
cornell's image is black, the showcase (the JAX package's tests use the
reference snapshot's scene, which is not in the repo).  Two CLI
processes join a gloo group through the environment protocol
(``RAYTRACE_TPU_COORDINATOR`` at a free port) and write one BMP,
which must equal the one-process CLI's byte for byte, also where one rank
gets only pad rows; the bands must equal the one-process image's rows to
the bit."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.parallel.multihost import (
    render_rows_multihost as jax_rows)
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.parallel import multihost
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene.builder import load_scene_file

import test_torch_group as group
from conftest import REPO_ROOT
from test_torch_megakernel import assert_radiance_close

CORNELL = str(REPO_ROOT / "examples" / "cornell_indirect.txt")
SHOWCASE = str(REPO_ROOT / "examples" / "materials_showcase.txt")


def _scene(w, h, path=CORNELL):
    sc = load_scene_file(path, device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(sc.spec, width=w,
                                                            height=h))


def test_row_aligned_bands_odd_geometry_single_process():
    """One rank renders every row of any (W, H); the band equals the
    plain render to the bit, and the JAX package's band (over its 8
    devices) by the radiance rule."""
    sc = _scene(5, 3)
    row_lo, row_hi, band = multihost.render_rows_multihost(sc, seed=5, spp=2)
    assert (row_lo, row_hi) == (0, 3)
    np.testing.assert_array_equal(band, render_image(sc, seed=5, spp=2))
    js = jax_load(CORNELL, dtype=jnp.float32)
    js = dataclasses.replace(js, spec=dataclasses.replace(js.spec, width=5,
                                                          height=3))
    jlo, jhi, jband = jax_rows(js, seed=5, spp=2)
    assert (jlo, jhi) == (0, 3)
    assert_radiance_close(band.reshape(-1, 3).T, jband.reshape(-1, 3).T)


@pytest.mark.parametrize("scene,w,h", [(CORNELL, 9, 7), (SHOWCASE, 3, 1)])
def test_two_rank_bands_stitch_bit_identically(scene, w, h, tmp_path):
    """Two ranks' bands of whole rows stitch to the one-process image; at
    3x1 rank 1 renders only a pad row and returns no rows."""
    sc = _scene(w, h, scene)
    outs = group.run_group(group.rows_job, 2, sc, 3, 2, out_dir=tmp_path)
    rows = -(-h // 2)
    assert [(lo, hi) for lo, hi, _ in outs] == [(0, min(rows, h)),
                                               (min(rows, h), h)]
    stitched = np.concatenate([band for _, _, band in outs])
    np.testing.assert_array_equal(stitched, render_image(sc, seed=3, spp=2))


def _cli(scene, args, env=None):
    return subprocess.Popen(
        [sys.executable, "-m", "raytrace_tpu_torch.cli", scene, "-q",
         "--device", "cpu", "--seed", "3", "--spp", "2", *args],
        cwd=str(REPO_ROOT), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.mark.parametrize("scene,w,h", [(CORNELL, 9, 7), (SHOWCASE, 3, 1)])
def test_two_process_cli_bmp_equals_one_process(scene, w, h, tmp_path):
    """The CLI run as two processes under the environment protocol writes
    one BMP, equal byte for byte to the one-process CLI's, also at 3x1,
    where rank 1 renders a pad row only (the showcase: cornell's one row
    is black there); its ``render_done`` event names the processes."""
    size = ["--width", str(w), "--height", str(h)]
    coord = f"localhost:{group.free_port()}"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RAYTRACE_TPU_")}
    procs = [_cli(scene, [*size, "-o", str(tmp_path / "multi.bmp"),
                          "--log-json", str(tmp_path / f"log{r}.jsonl")],
                  env=dict(env, RAYTRACE_TPU_COORDINATOR=coord,
                           RAYTRACE_TPU_NUM_PROCESSES="2",
                           RAYTRACE_TPU_PROCESS_ID=str(r)))
             for r in range(2)]
    one = _cli(scene, [*size, "-o", str(tmp_path / "one.bmp")], env=env)
    try:
        outs = [p.communicate(timeout=120)[0] for p in (*procs, one)]
    finally:
        for p in (*procs, one):
            if p.poll() is None:
                p.kill()
    for p, out in zip((*procs, one), outs):
        assert p.returncode == 0, out[-4000:]
    blob = (tmp_path / "multi.bmp").read_bytes()
    assert blob == (tmp_path / "one.bmp").read_bytes()
    assert len(blob) == 122 + ((3 * w + 3) & ~3) * h and any(blob[122:])
    for r in range(2):
        log = (tmp_path / f"log{r}.jsonl").read_text()
        assert '"render_done"' in log and '"processes": 2' in log


def test_barrier_failure_is_hard_error(monkeypatch):
    """A failed barrier aborts the shared-BMP write, never sleeps and
    races it."""
    monkeypatch.setattr(multihost, "process_count", lambda: 2)

    def boom():
        raise TimeoutError("coordinator unreachable")

    monkeypatch.setattr(torch.distributed, "barrier", boom)
    with pytest.raises(RuntimeError, match="barrier 'bmp_header' failed"):
        multihost._barrier("bmp_header")
