"""The image loop's float64 sum on a card (``integrator._accumulate`` and
``integrator._fetch``): the device's fold of float32 group means equals
numpy's to the bit at the benchmark cells' group weights, the image a
render returns is float64 in page-locked host memory, and a render that
keeps one group queued ahead of the host's wait gives the in-order
render's image.  The tests need a CUDA device; the CPU's fold and order
are held in ``test_torch_integrator.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.scene.builder import load_scene_file
from raytrace_tpu_torch.utils import profiling

from conftest import repo_path

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
# a group's share of a render's samples in the cells: golden's 6-sample
# chunks, 32-chunk groups, its 60-sample group and 4-sample tail (1024
# samples a pixel); field1k_mix's one-launch groups and field1k's one group
# (16 samples a pixel)
WEIGHTS = (6 / 1024, 192 / 1024, 60 / 1024, 4 / 1024, 4 / 16, 16 / 16)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_device_fold_equals_numpy_fold(cuda_device):
    """Random float32 means over six decades, folded group by group in
    float64 on the card, give numpy's ``astype``, ``*`` and ``+=`` to the
    bit; the fetched image is float64 and page-locked."""
    rs = np.random.RandomState(22)
    n = 1 << 18
    host = np.zeros((n, 3), np.float64)
    acc = torch.zeros((n, 3), dtype=torch.float64, device=cuda_device)
    for w in WEIGHTS + WEIGHTS[::-1]:
        g = (rs.uniform(0.0, 1.0, (n, 3))
             * 10.0 ** rs.uniform(-3.0, 3.0, (n, 3))).astype(np.float32)
        host += g.astype(np.float64) * w
        integrator._accumulate(acc, torch.from_numpy(g).to(cuda_device), w)
    got = integrator._fetch(acc)
    assert got.dtype == np.float64 and got.shape == (n, 3)
    assert np.array_equal(got, host)
    assert torch.from_numpy(got).is_pinned()


@pytest.mark.cuda
def test_render_on_card_is_the_host_fold_and_pinned(cuda_device,
                                                      monkeypatch):
    """A render of four groups on the card (K1) returns the host fold of
    the same groups' means to the bit, float64, in page-locked memory."""
    sc = load_scene_file(CORNELL, device=cuda_device)
    sc = dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=64, height=48))
    spec, spp, max_lanes = sc.spec, 7, 64 * 48 * 2
    s_launch, p_launch = integrator._s_p_launch(spec, spp, max_lanes)
    pix = torch.arange(64 * 48, device=cuda_device)
    want = np.zeros((64 * 48, 3), np.float64)
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    groups = list(integrator.sample_groups(spec, spp, s_launch))
    assert len(groups) == 4
    for s0, sl, g in groups:
        out = integrator._render_chunks(sc.data, spec, pix % 64, pix // 64,
                                        s0, sl, g, 5, p_launch)
        want += out.cpu().numpy().astype(np.float64) * (g * sl / spp)
    got = integrator._image_loop(sc, seed=5, spp=spp, max_lanes=max_lanes,
                                 progress=None, checkpoint=None)
    assert got.dtype == np.float64 and got.shape == (48, 64, 3)
    assert np.array_equal(got.reshape(-1, 3), want)
    assert torch.from_numpy(got).is_pinned()


@pytest.mark.cuda
@pytest.mark.parametrize("path", [CORNELL, SHOWCASE])
def test_queued_ahead_render_is_the_in_order_one(cuda_device, tmp_path,
                                                 monkeypatch, path):
    """A render of four groups on the card (K1; K3 with the showcase's
    lights and lens samples), each group issued before the host waits for
    the one before it, gives to the bit the image of the same render with
    a checkpoint path, which issues every group after the last one has
    finished; its ``wait`` spans read ``ahead`` 1 for all but the last
    group, and the checkpointed render records none."""
    sc = load_scene_file(path, device=cuda_device)
    sc = dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=64, height=48))
    spp, max_lanes = 7, 64 * 48 * 2 * sc.spec.cam_samples
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    kw = dict(seed=8, spp=spp, max_lanes=max_lanes, progress=None)
    s_launch, _ = integrator._s_p_launch(sc.spec, spp, max_lanes)
    assert len(list(integrator.sample_groups(sc.spec, spp, s_launch))) == 4
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        ahead = integrator._image_loop(sc, checkpoint=None, **kw)
        waits = [r.counts for r in profiling.recorded() if r.name == "wait"]
        profiling.clear()
        in_order = integrator._image_loop(
            sc, checkpoint=str(tmp_path / "state.npz"), **kw)
        assert not [r for r in profiling.recorded() if r.name == "wait"]
    assert waits == [{"ahead": 1}] * 3 + [{"ahead": 0}]
    assert np.array_equal(ahead, in_order)
