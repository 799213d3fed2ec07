"""The port's entry points (``raytrace_tpu_torch/entry.py``) on the
CPU: the forward of ``entry()`` against the JAX package's
``__graft_entry__.entry()`` forward on the same scene, and
``dryrun_multichip`` over gloo groups of 2 and 4 ranks against the
one-process step and render."""

import shutil

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from raytrace_tpu_torch import entry as entrylib
from raytrace_tpu_torch.optim import loss_and_grad
from raytrace_tpu_torch.render.integrator import render_image

from conftest import repo_path
from test_torch_group import dryrun_job, run_group
from test_torch_megakernel import assert_radiance_close

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))


def test_entry_forward_matches_jax(monkeypatch, tmp_path):
    """Both entry points on examples/cornell_indirect.txt (the JAX one
    reads it as the reference snapshot's test_scene.txt): the same shapes
    and arguments, and the forward within the K1 parity rule."""
    shutil.copy(CORNELL, tmp_path / "test_scene.txt")
    monkeypatch.setattr(graft, "REFERENCE_DIR", str(tmp_path))
    monkeypatch.setattr(graft, "_cache", lambda: None)
    jfn, jargs = graft.entry()
    want = np.asarray(jax.jit(jfn)(*jargs), np.float64)

    fn, args = entrylib.entry(device="cpu")
    data, px, py, sids = args
    assert data.device.type == "cpu" and data.dtype == torch.float32
    for got, ref in zip((px, py, sids), jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = fn(*args)
    assert got.shape == want.shape == (128, 3)
    assert_radiance_close(got.double().numpy().T, want.T)


def test_entry_main_prints_the_forward(capsys):
    assert entrylib.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and out[0].startswith("entry forward: (128, 3) ")
    assert float(out[0].rsplit(" ", 1)[1]) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_over_gloo_ranks(n, tmp_path):
    """One sharded step, an Adam update and a sharded render on n ranks
    (4 take the 2 x 2 mesh): every rank's loss is the one-process loss of
    the same pixels, and its image the one-process render to the bit."""
    got = run_group(dryrun_job, n, n, out_dir=tmp_path)
    shape = {"dcn": 2, "ici": 2} if n == 4 else {"d": 2}
    sc = entrylib.golden_scene("cpu", width=8, height=n)
    pix = torch.arange(8 * n, dtype=torch.int64)
    loss, _ = loss_and_grad(sc.data, sc.spec, pix % 8, pix // 8,
                            torch.arange(2, dtype=torch.int64), 0,
                            torch.zeros((8 * n, 3)))
    image = render_image(sc, seed=0, spp=2)
    for res, printed in got:
        assert res["mesh"] == shape
        assert res["loss"] == pytest.approx(float(loss), rel=1e-5)
        assert res["moved"] > 0
        np.testing.assert_array_equal(res["image"], image)
        assert printed == (f"dryrun_multichip({n}): mesh={shape} "
                           f"loss={res['loss']:.4f} ok\n")
