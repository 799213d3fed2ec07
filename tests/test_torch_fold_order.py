"""The order of the sphere rows in the fold's table
(``ops/intersect.py::scene_tables``, ``compact_order``): the scene-order
table's rows and ids regrouped into compact chunks, every result of the
fold the same to the bit, and fewer chunks entered.  The render kernels'
images with and without the regrouping: the ``cuda``-marked test."""

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.ops import intersect, intersect_scan
from raytrace_tpu_torch.ops.intersect import _packed_tables, scene_tables
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.scene.procedural import make_sphere_field

FIELDS = [(100, False), (100, True), (1000, False), (1000, True)]


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _camera_rays(sc, n, seed):
    """Primary rays of ``n`` random pixels and samples of the field's own
    camera."""
    rs = np.random.RandomState(seed)
    spec = sc.spec
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in (
        rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
        rs.randint(0, 16, n), np.zeros(n))]
    ro, rd, _, _ = integrator.primary_rays(sc.data, spec, *lanes, seed)
    return ro, rd


def _random_rays(n, seed):
    """Origins all over the field's box, directions uniform."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-28, -9, -28], [28, 28, 28], (n, 3)).astype(np.float32)
    return _v3(ro), _v3(rs.normal(0, 1, (n, 3)).astype(np.float32))


@pytest.mark.parametrize("n, mix", FIELDS)
def test_table_is_the_scene_order_table_regrouped(n, mix):
    """The fold's table holds the scene-order table's sphere rows, each
    with its own id, in another order; the pad rows end the sphere
    partition; the partition's size, the planes and the object rows are
    the scene order's; the same scene gives the same table."""
    sc = make_sphere_field(n, mix_materials=mix, device="cpu")
    table, n_sph_pad, ids = _packed_tables(sc.data, sc.spec)
    tb = scene_tables(sc.data, sc.spec)
    n_sph = n + 1   # the spheres of the field and its dome
    assert tb.n_sph_pad == n_sph_pad and tb.table.shape == table.shape
    perm = torch.searchsorted(ids[:n_sph], tb.ids[:n_sph])
    assert torch.equal(torch.sort(perm).values, torch.arange(n_sph))
    assert not torch.equal(perm, torch.arange(n_sph))
    assert torch.equal(tb.table[:n_sph], table[perm])
    assert torch.equal(tb.ids[:n_sph], ids[perm])
    assert (tb.ids[n_sph:n_sph_pad] == -1).all()
    assert torch.equal(tb.table[n_sph:], table[n_sph:])
    assert torch.equal(tb.ids[n_sph:], ids[n_sph:])
    assert torch.equal(tb.rows, intersect.object_table(sc.data, sc.spec))
    assert torch.equal(tb.bounds, intersect_scan._chunk_bounds(
        tb.table, n_sph_pad, table.shape[0] // intersect_scan.OBJ_CHUNK))
    again = make_sphere_field(n, mix_materials=mix, device="cpu")
    other = scene_tables(again.data, again.spec)
    assert other is not tb
    assert torch.equal(other.table, tb.table)
    assert torch.equal(other.ids, tb.ids)


@pytest.mark.parametrize("rays", ["camera", "random"])
@pytest.mark.parametrize("n, mix", FIELDS[::3])
def test_fold_gives_the_scene_order_bits(n, mix, rays):
    """The plain fold over the regrouped table, with and without its chunk
    bounds, equals the fold over the scene-order table: t, id and hit to
    the bit."""
    sc = make_sphere_field(n, mix_materials=mix, device="cpu")
    ro, rd = (_camera_rays(sc, 512, 3) if rays == "camera"
              else _random_rays(512, 4))
    table, n_sph_pad, ids = _packed_tables(sc.data, sc.spec)
    want = intersect_scan.scan_hit_reference(table, ids, n_sph_pad, ro, rd)
    tb = scene_tables(sc.data, sc.spec)
    for bounds in (None, tb.bounds):
        got = intersect_scan.scan_hit_reference(tb.table, tb.ids,
                                                tb.n_sph_pad, ro, rd, bounds)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert want[2].any() and (rays == "random" or want[2].all())


def test_camera_rays_enter_under_half_the_chunks():
    """On the 1,000-sphere field's camera rays a ray enters at most half
    as many chunks of the regrouped table as of the scene-order one."""
    sc = make_sphere_field(1000, mix_materials=False, device="cpu")
    ro, rd = _camera_rays(sc, 1024, 5)
    table, n_sph_pad, ids = _packed_tables(sc.data, sc.spec)
    bounds = intersect_scan._chunk_bounds(
        table, n_sph_pad, table.shape[0] // intersect_scan.OBJ_CHUNK)
    scene_order = intersect_scan.scan_hit_reference(
        table, ids, n_sph_pad, ro, rd, bounds, return_entered=True)[3]
    tb = scene_tables(sc.data, sc.spec)
    compact = intersect_scan.scan_hit_reference(
        tb.table, tb.ids, tb.n_sph_pad, ro, rd, tb.bounds,
        return_entered=True)[3]
    assert compact.double().mean() <= 0.5 * scene_order.double().mean()
    assert tb.bounds[:, 3].mean() < bounds[:, 3].mean()


def test_large_spheres_go_last():
    """A sphere larger than the chunks' bounds (the field's dome) is split
    apart from the others and its rows come after theirs; without one the
    order is the median splits' alone."""
    sc = make_sphere_field(1000, mix_materials=False, device="cpu")
    tb = scene_tables(sc.data, sc.spec)
    assert tb.ids[1000] == 5   # the dome, object 5, last of the spheres
    sph = _packed_tables(sc.data, sc.spec)[0][:1001].numpy()
    small = sph[1:]
    np.testing.assert_array_equal(
        intersect.compact_order(small[:, :3], small[:, 3]),
        intersect._median_splits(small[:, :3]))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", [False, True])
def test_render_kernels_give_the_scene_order_image(cuda_device, monkeypatch,
                                                   mix):
    """A 200-sphere field through K1-large (linear) and K3-large (mixed):
    the image of the regrouped table equals that of the table in scene
    order (``compact_order`` made the identity) to the bit."""
    kernel = megakernel.KERNEL_TREE if mix else megakernel.KERNEL_LINEAR

    def render():
        sc = make_sphere_field(200, width=64, height=48, antialias=4,
                               mix_materials=mix, device=cuda_device)
        before = megakernel.LAUNCHES[kernel]
        img = integrator.render_image(sc, seed=7)
        assert megakernel.LAUNCHES[kernel] > before
        return img, scene_tables(sc.data, sc.spec).ids.cpu()

    got, got_ids = render()
    monkeypatch.setattr(intersect, "compact_order",
                        lambda centres, radii: np.arange(len(centres)))
    want, want_ids = render()
    assert not torch.equal(got_ids, want_ids)
    np.testing.assert_array_equal(got, want)
    assert got.std() > 0
