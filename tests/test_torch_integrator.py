"""Integrator parity of the PyTorch port: sample_pixels and render_image
against the JAX package, the image loop's float64 sum against the host
fold it replaced, checkpoint resume, and launch retry."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render import integrator as jax_int
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import repo_path
from test_torch_megakernel import assert_radiance_close

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))


def _scenes(w, h):
    js = jax_load(CORNELL, dtype=jnp.float32)
    ts = torch_load(CORNELL, device="cpu")
    js = dataclasses.replace(js, spec=dataclasses.replace(js.spec, width=w,
                                                          height=h))
    ts = dataclasses.replace(ts, spec=dataclasses.replace(ts.spec, width=w,
                                                          height=h))
    return js, ts


def test_sample_pixels_matches_jax():
    js, ts = _scenes(16, 16)
    pix = np.arange(256)
    px, py, sids = pix % 16, pix // 16, np.arange(2)
    want = jax_int.sample_pixels(js.data, js.spec,
                                 *(jnp.asarray(a, jnp.uint32)
                                   for a in (px, py, sids)), 5)
    got = integrator.sample_pixels(ts.data, ts.spec,
                                   *(torch.from_numpy(a) for a in
                                     (px, py, sids)), 5)
    assert got.shape == (256, 3) and got.dtype == torch.float32
    assert_radiance_close(got.double().numpy().T,
                          np.asarray(want, np.float64).T)


def test_lane_ids_match_jax_layout():
    """One launch's lanes: (pixel, aa sample, lens sample), flattened with
    the lens sample fastest, as the JAX package's sample_pixels lays them
    out (np.repeat / np.tile)."""
    rs = np.random.RandomState(4)
    px, py, sids = (rs.randint(0, 64, 5), rs.randint(0, 64, 5),
                    rs.randint(0, 64, 3))
    got = integrator.lane_ids(*(torch.from_numpy(a) for a in (px, py, sids)),
                              4)
    want = (np.repeat(px, 12), np.repeat(py, 12),
            np.tile(np.repeat(sids, 4), 5), np.tile(np.arange(4), 15))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_primary_rays_match_jax():
    js, ts = _scenes(512, 512)
    rs = np.random.RandomState(11)
    ids = [rs.randint(0, 512, 4096), rs.randint(0, 512, 4096),
           rs.randint(0, 256, 4096), np.zeros(4096, np.int64)]
    jro, jrd, jk1, jk2 = jax_int.primary_rays(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in ids), 3)
    tro, trd, tk1, tk2 = integrator.primary_rays(
        ts.data, ts.spec, *(torch.from_numpy(a) for a in ids), 3)
    for got, want in ((tk1, jk1), (tk2, jk2)):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))
    for got, want in zip((*tro, *trd), (*jro, *jrd)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("significance", [None, 0.5])
def test_radiance_matches_jax(significance):
    """``integrator.radiance``, the (N, 3) wrapper, against the JAX
    package's on the same primary rays and streams, with the default and
    a given initial significance."""
    js, ts = _scenes(64, 64)
    rs = np.random.RandomState(2)
    ids = [rs.randint(0, 64, 1024), rs.randint(0, 64, 1024),
           rs.randint(0, 8, 1024), np.zeros(1024, np.int64)]
    jro, jrd, jk1, jk2 = jax_int.primary_rays(
        js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in ids), 7)
    tro, trd, tk1, tk2 = integrator.primary_rays(
        ts.data, ts.spec, *(torch.from_numpy(a) for a in ids), 7)
    want = jax_int.radiance(js.data, js.spec, jnp.stack(list(jro), -1),
                            jnp.stack(list(jrd), -1), jk1, jk2, significance)
    got = integrator.radiance(ts.data, ts.spec, torch.stack(list(tro), -1),
                              torch.stack(list(trd), -1), tk1, tk2,
                              significance)
    assert got.shape == (1024, 3) and got.dtype == torch.float32
    assert_radiance_close(got.double().numpy().T,
                          np.asarray(want, np.float64).T)


def test_render_image_matches_jax():
    js, ts = _scenes(8, 8)
    want = jax_int.render_image(js, seed=2, spp=4)
    got = integrator.render_image(ts, seed=2, spp=4)
    assert got.shape == (8, 8, 3) and got.dtype == np.float64
    assert_radiance_close(got.reshape(-1, 3).T, want.reshape(-1, 3).T)


def test_checkpoint_resume(tmp_path, monkeypatch):
    _, ts = _scenes(8, 8)
    ck = str(tmp_path / "state.npz")
    full = integrator.render_image(ts, seed=1, spp=4)

    class Stop(Exception):
        pass

    def stop_in_second(frac):
        # progress runs before each group's checkpoint write
        if frac >= 0.5:
            raise Stop

    # one sample per group: killed in the second, resumed after the first
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    with pytest.raises(Stop):
        integrator._image_loop(ts, seed=1, spp=4, max_lanes=64,
                               progress=stop_in_second, checkpoint=ck)
    with np.load(ck) as state:
        assert int(state["s_done"]) == 1
    resumed = integrator._image_loop(ts, seed=1, spp=4, max_lanes=64,
                                     progress=None, checkpoint=ck)
    np.testing.assert_allclose(resumed, full, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="different render config"):
        integrator.render_image(ts, seed=9, spp=4, checkpoint=ck)


def _host_fold(sc, seed, spp, max_lanes):
    """The image loop's sum as the host made it before the sum moved to
    the device: each group's mean fetched and added into a float64 numpy
    image.  Returns the image and the number of groups."""
    spec = sc.spec
    s_launch, p_launch = integrator._s_p_launch(spec, spp, max_lanes)
    pix = torch.arange(spec.width * spec.height)
    image = np.zeros((pix.shape[0], 3), np.float64)
    groups = list(integrator.sample_groups(spec, spp, s_launch))
    for s0, sl, g in groups:
        out = integrator._render_chunks(sc.data, spec, pix % spec.width,
                                        pix // spec.width, s0, sl, g, seed,
                                        p_launch)
        image += out.numpy().astype(np.float64) * (g * sl / spp)
    return image.reshape(spec.height, spec.width, 3), len(groups)


def _small(path, w, h):
    sc = torch_load(path, device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(sc.spec, width=w,
                                                            height=h))


@pytest.mark.parametrize("path,max_lanes", [
    (CORNELL, 128),     # 2-sample chunks, a ragged 1-sample tail
    (CORNELL, 32),      # 1-sample chunks over two pixel tiles
    (SHOWCASE, 512),    # fan-out, 4 lens samples a primary sample
])
def test_image_loop_sum_equals_the_host_fold(path, max_lanes, monkeypatch):
    """The device-resident float64 sum (``_accumulate``, then one
    ``_fetch``) gives the host fold's image to the bit, over three groups
    or more, in float64."""
    sc = _small(path, 8, 8)
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    want, n_groups = _host_fold(sc, 3, 5, max_lanes)
    assert n_groups >= 3
    got = integrator._image_loop(sc, seed=3, spp=5, max_lanes=max_lanes,
                                 progress=None, checkpoint=None)
    assert got.dtype == np.float64 and got.shape == (8, 8, 3)
    assert np.array_equal(got, want)


def test_resumed_render_equals_the_uninterrupted_one(tmp_path, monkeypatch):
    """A render killed after its first checkpointed group and resumed
    from the file gives the uninterrupted render's image to the bit."""
    sc = _small(CORNELL, 8, 8)
    ck = str(tmp_path / "state.npz")
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    kw = dict(seed=4, spp=5, max_lanes=128)
    full = integrator._image_loop(sc, progress=None, checkpoint=None, **kw)

    class Stop(Exception):
        pass

    def stop_in_second(frac):
        if frac > 0.5:
            raise Stop

    with pytest.raises(Stop):
        integrator._image_loop(sc, progress=stop_in_second, checkpoint=ck,
                               **kw)
    with np.load(ck) as state:
        assert int(state["s_done"]) == 2
        assert state["image"].dtype == np.float64
    resumed = integrator._image_loop(sc, progress=None, checkpoint=ck, **kw)
    assert np.array_equal(resumed, full)


def test_s_p_launch_fills_the_budget():
    _, ts = _scenes(8, 8)
    assert integrator._s_p_launch(ts.spec, 16, 1 << 22) == (16, 64)
    assert integrator._s_p_launch(ts.spec, 16, 256) == (4, 64)
    assert integrator._s_p_launch(ts.spec, 16, 32) == (1, 32)


def test_retry_launch_transient_vs_permanent(monkeypatch):
    monkeypatch.setattr(integrator.time, "sleep", lambda s: None)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise RuntimeError("transient device hiccup")
        return torch.ones(2)

    assert integrator._retry_launch(flaky).tolist() == [1.0, 1.0]
    assert len(calls) == 2

    for err in (torch.OutOfMemoryError("CUDA out of memory"),
                NotImplementedError("not ported"),
                RuntimeError("megakernel launch failed: invalid argument")):
        calls.clear()

        def permanent(err=err):
            calls.append(1)
            raise err

        with pytest.raises(type(err)):
            integrator._retry_launch(permanent)
        assert len(calls) == 1


def _synchronous(n, issue, finish):
    """In place of ``integrator._lookahead``: no group queued ahead, every
    group issued after the last one has finished, as a checkpointed
    render's are."""
    return 0


def _spied(monkeypatch, events):
    """``sample_pixels`` noting each call's first sample id in ``events``,
    and a progress callback noting its fraction there."""
    inner = integrator.sample_pixels

    def spy(data, spec, px, py, sample_ids, seed, radiance=None):
        events.append(("sample", int(sample_ids[0])))
        return inner(data, spec, px, py, sample_ids, seed, radiance)

    monkeypatch.setattr(integrator, "sample_pixels", spy)
    return lambda frac: events.append(("progress", frac))


@pytest.mark.parametrize("spp,checkpointed", [
    (2, False),         # one group: nothing to queue ahead
    (4, False),         # two groups
    (6, False),         # three groups
    (5, False),         # two groups and a ragged 1-sample tail
    (5, True),          # checkpointed: the groups one after another
])
def test_next_group_is_issued_before_the_wait(tmp_path, monkeypatch, spp,
                                              checkpointed):
    """Without a checkpoint, group k+1's ``sample_pixels`` calls come
    before group k's progress call, and group k+2's after it: one group
    queued ahead.  A checkpointed render calls progress before it issues
    the next group, and a render killed there resumes to the same bits.
    Every image is the synchronous order's to the bit."""
    sc = _small(CORNELL, 8, 8)
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    kw = dict(seed=6, spp=spp, max_lanes=128)
    s_launch, _ = integrator._s_p_launch(sc.spec, spp, 128)
    groups = list(integrator.sample_groups(sc.spec, spp, s_launch))
    assert len(groups) == {2: 1, 4: 2, 6: 3, 5: 3}[spp]
    with monkeypatch.context() as m:
        m.setattr(integrator, "_lookahead", _synchronous)
        want = integrator._image_loop(sc, progress=None, checkpoint=None,
                                      **kw)
    events = []
    progress = _spied(monkeypatch, events)
    ck = str(tmp_path / "state.npz") if checkpointed else None
    got = integrator._image_loop(sc, progress=progress, checkpoint=ck, **kw)
    assert np.array_equal(got, want)

    def group_of(s):
        return next(k for k, (s0, sl, g) in enumerate(groups)
                    if s0 <= s < s0 + sl * g)

    issued = [group_of(s) for kind, s in events if kind == "sample"]
    assert issued == sorted(issued) and set(issued) == set(range(len(groups)))
    # where each group's first sample_pixels call and its progress call
    # fall among the events
    first, done = {}, []
    for i, (kind, x) in enumerate(events):
        if kind == "progress":
            done.append(i)
        else:
            first.setdefault(group_of(x), i)
    assert [x for kind, x in events if kind == "progress"] == [
        (s0 + sl * g) / spp for s0, sl, g in groups]
    for k in range(len(groups) - 1):
        assert (first[k + 1] < done[k]) == (not checkpointed)
        if k + 2 < len(groups):
            assert done[k] < first[k + 2]
    if checkpointed:
        class Stop(Exception):
            pass

        def stop_in_second(frac):
            if frac > 0.5:
                raise Stop

        ck2 = str(tmp_path / "killed.npz")
        with pytest.raises(Stop):
            integrator._image_loop(sc, progress=stop_in_second,
                                   checkpoint=ck2, **kw)
        resumed = integrator._image_loop(sc, progress=None, checkpoint=ck2,
                                         **kw)
        assert np.array_equal(resumed, want)


@pytest.mark.parametrize("transient", [True, False])
def test_fault_at_a_groups_wait(monkeypatch, transient):
    """A transient failure surfacing at group 1's wait drops the groups in
    flight and redoes group 1 on in order: each group added once, the
    image the synchronous order's to the bit.  A permanent one raises at
    that wait, with no group issued again."""
    monkeypatch.setattr(integrator.time, "sleep", lambda s: None)
    sc = _small(CORNELL, 8, 8)
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 1)
    kw = dict(seed=7, spp=6, max_lanes=128, checkpoint=None)
    with monkeypatch.context() as m:
        m.setattr(integrator, "_lookahead", _synchronous)
        want = integrator._image_loop(sc, progress=None, **kw)
    events, waits, added = [], [], []
    progress = _spied(monkeypatch, events)
    err = RuntimeError("transient device hiccup" if transient else
                       "CUDA error: an illegal memory access was "
                       "encountered")

    def wait(done):
        waits.append(1)
        if len(waits) == 2:
            raise err

    inner = integrator._accumulate

    def accumulate(acc, out, weight):
        added.append(weight)
        inner(acc, out, weight)

    monkeypatch.setattr(integrator, "_wait", wait)
    monkeypatch.setattr(integrator, "_accumulate", accumulate)
    if not transient:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            integrator._image_loop(sc, progress=progress, **kw)
        # groups 0 and 1 issued, group 2 queued behind group 1's wait; no
        # group issued twice, only group 0 added
        assert [s for kind, s in events if kind == "sample"] == [0, 2, 4]
        assert len(waits) == 2 and added == [2 / 6]
        return
    got = integrator._image_loop(sc, progress=progress, **kw)
    assert np.array_equal(got, want)
    # group 1 and the queued group 2 issued again, in order; three adds
    assert [s for kind, s in events if kind == "sample"] == [0, 2, 4, 2, 4]
    assert added == [2 / 6] * 3
    assert [x for kind, x in events if kind == "progress"] == [
        2 / 6, 4 / 6, 6 / 6]


@pytest.mark.parametrize("scene", ["cornell_indirect.txt",
                                   "materials_showcase.txt"])
def test_group_bound_scales_with_wavefront_widest(scene, monkeypatch):
    """_image_loop bounds a launch group's work as the JAX package does:
    lanes times _wavefront_widest, the fan-out of the widest level."""
    path = str(repo_path("examples", scene))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    assert integrator._wavefront_widest(ts.spec) == jax_int._wavefront_widest(
        js.spec)
    spec = dataclasses.replace(ts.spec, width=512, height=512, cam_samples=1)
    calls = []
    monkeypatch.setattr(
        integrator, "_render_chunks",
        lambda data, spec, px, py, s0, sl, g, seed, p_launch: (
            calls.append((sl, g)) or torch.zeros((px.shape[0], 3))))
    integrator._image_loop(dataclasses.replace(ts, spec=spec), seed=0,
                           spp=64, max_lanes=1 << 22, progress=None,
                           checkpoint=None)
    s_launch = calls[0][0]
    assert s_launch == 16
    work = 512 * 512 * s_launch * jax_int._wavefront_widest(spec)
    cap = max(min(32, (1 << 28) // work), 1)
    assert cap == integrator._group_cap(spec, s_launch)
    assert calls[0][1] == min(cap, 64 // s_launch)
    assert sum(sl * g for sl, g in calls) == 64
    if scene == "materials_showcase.txt":
        # 4 slots, 2 live: 4 * 2**4 = 64 lanes per sample at the widest,
        # so each group takes one chunk, where a linear chain takes four
        assert integrator._wavefront_widest(spec) == 64
        assert [g for _, g in calls] == [1, 1, 1, 1]
    else:
        assert [g for _, g in calls] == [4]
