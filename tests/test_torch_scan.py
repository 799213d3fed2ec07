"""The port's scan closest-hit (ops/intersect_scan.py) and the tables it
reads, against the JAX package: the Pallas scan kernel in interpret mode
and its plain lax.scan reference, on the same numpy rays."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import intersect_pallas as jip
from raytrace_tpu.ops.intersect import _packed_tables as jax_packed_tables
from raytrace_tpu.ops.intersect import packed_object_table
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.ops import _build, intersect_scan
from raytrace_tpu_torch.ops.intersect import (_packed_tables, object_table,
                                              scene_tables)
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.procedural import make_sphere_field


@pytest.fixture()
def interpret_env(monkeypatch):
    monkeypatch.setenv("RAYTRACE_TPU_MEGAKERNEL_INTERPRET", "1")


def _v3(a, lib):
    if lib is torch:
        return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                    for i in range(3)))
    return JV3(*(jnp.asarray(a[:, i]) for i in range(3)))


def _camera_rays(n, seed):
    """Rays from around the sphere field's camera, in every direction."""
    r = np.random.RandomState(seed)
    ro = np.repeat([[0.0, 4.0, 28.0]], n, 0) + r.normal(0, 0.5, (n, 3))
    return ro.astype(np.float32), r.normal(0, 1, (n, 3)).astype(np.float32)


def _incoherent_rays(n, seed):
    """Origins all over the box, directions uniform; four dead lanes."""
    r = np.random.RandomState(seed)
    ro = r.uniform([-28, -9, -28], [28, 28, 28], (n, 3))
    rd = r.normal(0, 1, (n, 3))
    rd[5:9] = 0.0
    return ro.astype(np.float32), rd.astype(np.float32)


def _distant_rays(n, seed, centers, radii):
    """Rays from 5,000 units out aimed at sphere centers, every second
    one grazing at 0.995 r (tests/test_intersect_pallas.py:112)."""
    r = np.random.RandomState(seed)
    far = np.array([3000.0, 4000.0, 5000.0])
    idx = r.randint(0, len(radii), n)
    aim = centers[idx].astype(np.float64)
    tang = r.normal(0, 1, (n, 3))
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    graze = aim + tang * (radii[idx] * 0.995)[:, None]
    rd = np.where((np.arange(n) % 2 == 0)[:, None], aim, graze) - far
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return (np.repeat(far[None], n, 0).astype(np.float32),
            rd.astype(np.float32))


def _rays(kind, ts):
    if kind == "camera":
        return _camera_rays(333, 0)
    if kind == "incoherent":
        return _incoherent_rays(300, 1)
    p = ts.data.prim_p.numpy()[6:]
    return _distant_rays(256, 11, p, ts.data.prim_q.numpy()[6:, 0])


@pytest.mark.parametrize("mix", [False, True])
def test_tables_match_jax(mix):
    """The unified table, its ids and partition size, and the per-object
    row table: exact.  Chunk bounds: 1e-6 relative (a sum of up to 32
    centers may be taken in another order)."""
    js = jax_field(100, mix_materials=mix)
    ts = make_sphere_field(100, mix_materials=mix, device="cpu")
    want_table, want_pad, want_ids = jax_packed_tables(js.data, js.spec)
    table, n_sph_pad, ids = _packed_tables(ts.data, ts.spec)
    assert n_sph_pad == want_pad == 128 and table.shape == (160, 4)
    assert ids.dtype == torch.int32 and table.dtype == torch.float32
    np.testing.assert_array_equal(table.numpy(), np.asarray(want_table))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    assert (ids.numpy()[101:128] == -1).all() and ids[128] == 0
    np.testing.assert_array_equal(
        object_table(ts.data, ts.spec).numpy(),
        np.asarray(packed_object_table(js.data, js.spec)))
    want_b = np.asarray(jip._chunk_bounds(want_table, want_pad, 5))
    got_b = intersect_scan._chunk_bounds(table, n_sph_pad, 5).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=1e-6, atol=0)
    assert (got_b[4] == 0).all() and (got_b[:4, 3] > 0).all()
    tb = scene_tables(ts.data, ts.spec)
    assert scene_tables(ts.data, ts.spec) is tb
    # the fold's table: the same sphere rows, ids carried along, regrouped
    perm = torch.searchsorted(ids[:101], tb.ids[:101])
    assert torch.equal(torch.sort(perm).values, torch.arange(101))
    assert torch.equal(tb.table[:101], table[perm])
    assert torch.equal(tb.ids[:101], ids[perm])
    assert torch.equal(tb.table[101:], table[101:])
    assert torch.equal(tb.ids[101:], ids[101:])
    assert tb.n_sph_pad == 128 and torch.equal(
        tb.bounds, intersect_scan._chunk_bounds(tb.table, 128, 5))


def test_empty_partition_takes_one_chunk():
    """A scene of spheres only: the plane partition is one all-pad chunk."""
    import dataclasses

    ts = make_sphere_field(40, device="cpu")
    keep = [i for i, t in enumerate(ts.spec.shape_type) if t == 0]
    spec = dataclasses.replace(
        ts.spec, shape_type=tuple(t if i in keep else -1 for i, t in
                                  enumerate(ts.spec.shape_type)))
    table, n_sph_pad, ids = _packed_tables(ts.data, spec)
    assert n_sph_pad == 64 and table.shape == (96, 4)
    assert (ids[64:] == -1).all() and not table[64:].any()
    assert sorted(ids[:41].tolist()) == keep


@pytest.mark.parametrize("kind", ["camera", "incoherent", "distant"])
def test_scan_reference_matches_jax(kind, interpret_env):
    """scan_hit_reference against the Pallas kernel (interpret mode) and
    against _jnp_scan_reference: ids and hit exact; t within 1e-6
    relative on at least 98% of the hit lanes and within 1e-4 on all (XLA
    contracts ``b*b - 4ac`` into a fused multiply-add and PyTorch does
    not, which shows where the discriminant cancels, on grazing rays)."""
    js = jax_field(200, mix_materials=False)
    ts = make_sphere_field(200, mix_materials=False, device="cpu")
    ro, rd = _rays(kind, ts)
    jt, jpad, jids = jax_packed_tables(js.data, js.spec)
    table, n_sph_pad, ids = _packed_tables(ts.data, ts.spec)
    t, gid, hit = intersect_scan.scan_hit_reference(
        table, ids, n_sph_pad, _v3(ro, torch), _v3(rd, torch))
    assert gid.dtype == torch.int32 and hit.dtype == torch.bool
    for fn in (jip.scan_hit, jip._jnp_scan_reference):
        wt, wg, wh = fn(jt, jids, jpad, _v3(ro, jnp), _v3(rd, jnp))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(gid.numpy(), np.asarray(wg))
        ok = hit.numpy()
        got_t, want_t = t.numpy()[ok], np.asarray(wt)[ok]
        np.testing.assert_allclose(got_t, want_t, rtol=1e-4)
        assert (np.abs(got_t - want_t) <= 1e-6 * want_t).mean() >= 0.98
        assert np.isinf(t.numpy()[~ok]).all()
    assert (gid.numpy()[~hit.numpy()] == intersect_scan.ID_SENTINEL).all()
    if kind == "distant":
        assert hit.numpy()[::2].mean() > 0.9
    else:
        assert 0.05 < hit.numpy().mean()


@pytest.mark.parametrize("kind", ["camera", "incoherent", "distant"])
def test_culling_changes_nothing(kind):
    """The plain fold with and without the bounding-sphere test: bit
    identical, while the test does skip chunks."""
    ts = make_sphere_field(200, mix_materials=False, device="cpu")
    ro, rd = _rays(kind, ts)
    if kind == "camera":   # lanes far outside and behind the box as well
        ro[100:164] += np.float32([500, 500, 500])
        ro[164:228] += np.float32([0, -9, -88])
    tb = scene_tables(ts.data, ts.spec)
    args = (tb.table, tb.ids, tb.n_sph_pad, _v3(ro, torch), _v3(rd, torch))
    plain = intersect_scan.scan_hit_reference(*args)
    *culled, entered = intersect_scan.scan_hit_reference(
        *args, bounds=tb.bounds, return_entered=True)
    for a, b in zip(plain, culled):
        assert torch.equal(a, b)
    n_sph_chunks = tb.n_sph_pad // intersect_scan.OBJ_CHUNK
    assert 0 < entered.float().mean() < n_sph_chunks
    assert plain[2].any() and (kind != "camera" or not plain[2].all())


def test_exact_tie_goes_to_the_lower_id():
    """Two coincident spheres and two coincident planes: the scan takes
    the lower object id whatever the row order."""
    table = torch.zeros((64, 4))
    table[0] = table[1] = torch.tensor([0.0, 0.0, -5.0, 1.0])
    table[32] = table[33] = torch.tensor([0.0, 0.0, 1.0, -9.0])
    ids = torch.full((64,), -1, dtype=torch.int32)
    ids[0], ids[1], ids[32], ids[33] = 7, 3, 9, 2
    ro = V3(*(torch.zeros(2) for _ in range(3)))
    rd = V3(torch.tensor([0.0, 0.9]), torch.tensor([0.0, 0.0]),
            torch.tensor([-1.0, -1.0]))
    t, gid, hit = intersect_scan.scan_hit_reference(table, ids, 32, ro, rd)
    assert hit.all() and gid.tolist() == [3, 2]
    assert t[0] == 4.0


def test_scan_hit_on_cpu_is_the_plain_version():
    ts = make_sphere_field(100, device="cpu")
    ro, rd = _camera_rays(64, 2)
    tb = scene_tables(ts.data, ts.spec)
    args = (tb.table, tb.ids, tb.n_sph_pad, _v3(ro, torch), _v3(rd, torch))
    before = dict(_build.LAUNCHES)
    got = intersect_scan.scan_hit(*args, tb.bounds)
    assert _build.LAUNCHES == before
    for a, b in zip(got, intersect_scan.scan_hit_reference(*args)):
        assert torch.equal(a, b)
    # a table that requires grad goes through, and t carries the gradient
    table = tb.table.clone().requires_grad_(True)
    t, gid, hit = intersect_scan.scan_hit(table, *args[1:])
    assert torch.equal(t, got[0]) and not gid.requires_grad
    grad, = torch.autograd.grad(torch.where(hit, t, 0.0).sum(), table)
    assert torch.isfinite(grad).all() and grad.abs().max() > 0
    with pytest.raises(ValueError):
        intersect_scan.scan_hit_reference(tb.table[:-1], tb.ids[:-1],
                                          tb.n_sph_pad, *args[3:])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_scan_kernel_matches_plain_version_on_card(cuda_device):
    ts = make_sphere_field(1000, mix_materials=False, device=cuda_device)
    ro, rd = _incoherent_rays(8192, 4)
    tb = scene_tables(ts.data, ts.spec)
    args = (tb.table, tb.ids, tb.n_sph_pad,
            V3(*(c.to(cuda_device) for c in _v3(ro, torch))),
            V3(*(c.to(cuda_device) for c in _v3(rd, torch))))
    before = _build.LAUNCHES[_build.KERNEL_SCAN]
    t, gid, hit = intersect_scan.scan_hit(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[_build.KERNEL_SCAN] == before + 1
    wt, wg, wh = intersect_scan.scan_hit_reference(*args)
    assert torch.equal(hit, wh)
    assert (gid == wg).float().mean() > 0.999
    same = (gid == wg) & hit
    torch.testing.assert_close(t[same], wt[same], rtol=1e-5, atol=0)
