"""The port's object-sharded ring (``raytrace_tpu_torch.parallel.ring``)
against the port's dense scan and render, and against the JAX package's
ring: twins of tests/test_ring.py, on the same scenes, seeds and sizes.
The port's ring runs as real gloo groups of 2 and 4 ranks on the CPU
(k = 1 needs none); the JAX side on its 8 virtual CPU devices, with the
jnp scan.  Both field scenes are above the 64-object threshold on purpose:
below it the dense path's per-object test and the scan's row formulas
round differently."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.parallel import ring as jax_ring
from raytrace_tpu.parallel.mesh import make_mesh as jax_mesh
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build, intersect, vec
from raytrace_tpu_torch.parallel import ring
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene.procedural import make_sphere_field
from raytrace_tpu_torch.scene.schema import BG_SKYBOX

import test_torch_group as group
from test_torch_megakernel import LANE_RTOL, MEAN_RTOL


def _rays(n, seed):
    r = np.random.RandomState(seed)
    ro = r.randn(n, 3) * 2
    d = r.randn(n, 3)
    return ro, d / np.linalg.norm(d, axis=1, keepdims=True)


def _ring(k, tmp_path, data, spec, ro, rd):
    if k == 1:
        return ring.make_ring_intersector(spec, make_mesh("cpu"))(data, ro,
                                                                  rd)
    outs = group.run_group(group.ring_intersect_job, k, data, spec, ro, rd,
                           out_dir=tmp_path)
    for other in outs[1:]:  # every rank gets every ray's result
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    return outs[0]


@pytest.mark.parametrize("k", [1, 2, 4])
def test_ring_matches_dense(k, tmp_path):
    """106 objects, float64, 512 rays: ids and hits exact and t equal to
    the bit against the port's dense scan; ids and hits exact and t to
    1e-12 against the JAX package's ring."""
    ts = make_sphere_field(100, device="cpu", dtype=torch.float64)
    ro, rd = _rays(512, 5)
    t, obj, hit = _ring(k, tmp_path, ts.data, ts.spec, torch.from_numpy(ro),
                        torch.from_numpy(rd))
    dense = intersect.closest_hit(ts.data, ts.spec,
                                  vec.splat(torch.from_numpy(ro)),
                                  vec.splat(torch.from_numpy(rd)))
    assert torch.equal(hit, dense.hit) and hit.any()
    assert torch.equal(obj.long(), dense.obj)
    assert torch.equal(t, dense.t)

    js = jax_field(100, dtype=jnp.float64)
    jt, jobj, jhit = jax_ring.make_ring_intersector(js.spec, jax_mesh())(
        js.data, jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(obj.numpy(), np.asarray(jobj))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-12)


def test_ring_empty_miss_rays(tmp_path):
    """Rays pointing away from everything miss on every rank: t = inf."""
    ts = make_sphere_field(20, device="cpu", dtype=torch.float64)
    ro = torch.tensor([[0.0, 0.0, 100.0]], dtype=torch.float64).repeat(64, 1)
    rd = torch.tensor([[0.0, 0.0, 1.0]], dtype=torch.float64).repeat(64, 1)
    t, obj, hit = _ring(2, tmp_path, ts.data, ts.spec, ro, rd)
    assert not hit.any() and torch.isinf(t).all() and not obj.any()


def test_shard_geometry_matches_jax():
    """The shards' rows and ids are the JAX package's, and at k = 1 the
    dense scan's table."""
    ts = make_sphere_field(100, device="cpu", dtype=torch.float64)
    js = jax_field(100, dtype=jnp.float64)
    for k in (1, 3, 4):
        tables, ids, n_sph = ring.shard_geometry(ts.data, ts.spec, k)
        jtables, jids, jn_sph = jax_ring.shard_geometry(js.data, js.spec, k)
        assert n_sph == jn_sph and tables.shape[0] == k
        np.testing.assert_array_equal(tables.numpy(), np.asarray(jtables))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    dense = intersect.scene_tables(ts.data, ts.spec)
    tables, ids, n_sph = ring.shard_geometry(ts.data, ts.spec, 1)
    assert n_sph == dense.n_sph_pad
    assert torch.equal(tables[0], dense.table) and torch.equal(ids[0],
                                                               dense.ids)
    mats = ring.shard_object_table(dense.rows, 4)
    assert mats.shape == (4, 27, 22)
    assert torch.equal(mats.reshape(-1, 22)[:106], dense.rows)


def _field(n, w, h, mix, max_depth=None):
    ts = make_sphere_field(n, width=w, height=h, antialias=1,
                           mix_materials=mix, device="cpu")
    js = jax_field(n, width=w, height=h, antialias=1, mix_materials=mix,
                   dtype=jnp.float32)
    if max_depth is not None:
        ts = dataclasses.replace(ts, spec=dataclasses.replace(
            ts.spec, max_depth=max_depth))
        js = dataclasses.replace(js, spec=dataclasses.replace(
            js.spec, max_depth=max_depth))
    return ts, js


@pytest.mark.parametrize("case", ["linear", "materials and lights"])
def test_render_image_ring_matches_dense(case, tmp_path):
    """The port's ring image at k = 2 equals its dense render to the bit,
    and the JAX package's ring image by the radiance rule: the 106-object
    linear field at 8x8, 2 spp (tests/test_ring.py:77), and the 76-object
    mixed field at 6x6, 1 spp, max_depth 2 (:95).  The rule's outlier
    budget (1% of lanes) is less than one of these images' 64 and 36
    pixels; the two packages' dense renders of the linear field part on 2
    of its 64, so the budget here is 2 pixels.  Anchored at float64
    (tests/test_torch_field_f64.py), where the packages agree to 1e-12:
    the port's float32 render parts from float64 on 2 of these 64 pixels
    and JAX's on 3, and the parted lanes fork at a near-tie, a secondary
    ray leaving the emissive dome from an origin within two float32 steps
    of its surface (inside it in JAX's compiled program, outside in the
    port)."""
    if case == "linear":
        (ts, js), seed, spp = _field(100, 8, 8, False), 2, 2
    else:
        (ts, js), seed, spp = _field(70, 6, 6, True, max_depth=2), 5, 1
    assert len(ts.spec.live_objects()) > intersect.LARGE_SCENE_THRESHOLD
    dense = render_image(ts, seed=seed, spp=spp)
    outs = group.run_group(group.ring_render_job, 2, ts, seed, spp,
                           out_dir=tmp_path)
    for img in outs:
        np.testing.assert_array_equal(img, dense)
    want = np.asarray(jax_ring.render_image_ring(js, seed=seed, spp=spp,
                                                 mesh=jax_mesh()))
    got = outs[0]
    assert np.isfinite(got).all() and dense.std() > 0.0
    off = np.abs(got - want) > LANE_RTOL * np.maximum(1.0, np.abs(want))
    assert off.any(axis=2).sum() <= 2, off.any(axis=2).sum()
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=MEAN_RTOL)


def test_ring_never_reads_stripped_object_leaves(monkeypatch):
    """A ring render replaces the object leaves by one-row dummies; a
    query that reached the scene's own tables would build one-row tables
    from them (on the card: a silent wrong image).  The hook intercepts
    first: no table is made from stripped data, and the image is the
    dense one.  Rendered without the ring, the stripped scene fails."""
    ts, _ = _field(100, 8, 8, False)
    made = []

    def guard(fn):
        def wrapped(data, spec):
            made.append(data.prim_p.shape[0])
            assert data.prim_p.shape[0] > 1, "a table of stripped data"
            return fn(data, spec)
        return wrapped

    monkeypatch.setattr(intersect, "object_table",
                        guard(intersect.object_table))
    monkeypatch.setattr(intersect, "scene_tables",
                        guard(intersect.scene_tables))
    monkeypatch.setattr(megakernel, "_scene_buffer",
                        guard(megakernel._scene_buffer))
    dense = render_image(ts, seed=2, spp=2)
    made.clear()
    got = ring.render_image_ring(ts, seed=2, spp=2, mesh=make_mesh("cpu"))
    np.testing.assert_array_equal(got, dense)
    assert made == [ts.data.prim_p.shape[0]]  # the ring's own shards
    stripped = dataclasses.replace(ts, data=ring.strip_object_data(ts.data))
    with pytest.raises(AssertionError, match="stripped"):
        render_image(stripped, seed=2, spp=2)


def test_ring_sky_misses_take_background_color(monkeypatch):
    """Under a ring context a skybox's misses go through
    ``background_color`` (the skybox kernel on CUDA tensors; ``_skybox``
    here), so the ring image of a sky scene is still the dense one; the
    split path is a one-shard ring and launches nothing on the CPU."""
    ts, _ = _field(100, 8, 8, False)
    g = torch.Generator().manual_seed(0)
    sky = dataclasses.replace(
        ts, spec=dataclasses.replace(ts.spec, bg_type=BG_SKYBOX,
                                     face_sizes=((4, 4),) * 6),
        data=dataclasses.replace(ts.data, bg_cube=torch.rand(
            (6, 4, 4, 3), generator=g)))
    calls = []
    real = backgrounds.background_color

    def counted(data, spec, rd):
        calls.append(rd.shape[0])
        return real(data, spec, rd)

    monkeypatch.setattr(backgrounds, "background_color", counted)
    dense = render_image(sky, seed=1, spp=2)
    assert not calls
    got = ring.render_image_ring(sky, seed=1, spp=2, mesh=make_mesh("cpu"))
    np.testing.assert_array_equal(got, dense)
    assert calls and all(n == 8 * 8 * 2 for n in calls)
    before = dict(_build.LAUNCHES)
    pix = torch.arange(64)
    split = megakernel.radiance_lanes_split(sky.data, sky.spec, pix % 8,
                                            pix // 8, pix % 2, pix * 0, 1)
    plain = megakernel.radiance_lanes_reference(sky.data, sky.spec, pix % 8,
                                                pix // 8, pix % 2, pix * 0, 1)
    for a, b in zip(split, plain):
        assert torch.equal(a, b)
    assert _build.LAUNCHES == before and intersect.ring_ctx() is None
