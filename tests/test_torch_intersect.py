"""Closest-hit and shadow-query parity of the PyTorch port against the
JAX package on random rays inside and outside the scenes' objects."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops.intersect import closest_hit as jax_closest_hit
from raytrace_tpu.ops.intersect import occluded_v as jax_occluded_v
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.ops.intersect import (closest_hit, occluded_v,
                                              safe_inv2a)
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import repo_path

N = 4096
FLOAT_FIELDS = ("t", "normal", "pt")
ROW_FIELDS = ("diffuse", "specular", "ambient", "exponent", "ior",
              "msamples", "is_fresnel", "is_transp", "is_indirect")


def _rays(seed):
    """Half the origins inside the box (x in +-3.5, y in 0..7, z > -4),
    half well outside it; directions uniform on the sphere."""
    rs = np.random.RandomState(seed)
    inside = rs.uniform([-3.4, 0.1, -3.9], [3.4, 6.9, 15.0], (N // 2, 3))
    outside = rs.uniform([-30, -10, -30], [30, 30, 40], (N // 2, 3))
    ro = np.concatenate([inside, outside]).astype(np.float32)
    rd = rs.normal(size=(N, 3))
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    return ro, rd


def _flat(v):
    """A HitRec field as a (N, k) float64 numpy array."""
    if isinstance(v, tuple):
        return np.stack([_flat(c)[:, 0] for c in v], 1)
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.astype(np.float64).reshape(-1, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_closest_hit_matches_jax(seed):
    path = str(repo_path("examples", "cornell_indirect.txt"))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    ro, rd = _rays(seed)
    want = jax_closest_hit(js.data, js.spec,
                           JV3(*(jnp.asarray(ro[:, i]) for i in range(3))),
                           JV3(*(jnp.asarray(rd[:, i]) for i in range(3))))
    got = closest_hit(ts.data, ts.spec,
                      V3(*(torch.from_numpy(ro[:, i]) for i in range(3))),
                      V3(*(torch.from_numpy(rd[:, i]) for i in range(3))))

    same = ((got.obj.numpy() == np.asarray(want.obj))
            & (got.hit.numpy() == np.asarray(want.hit)))
    assert same.mean() >= 0.999, same.mean()
    assert 0.01 < got.hit.numpy().mean() < 0.99  # both kinds of lanes
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(_flat(getattr(got, f))[same],
                                   _flat(getattr(want, f))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ROW_FIELDS:
        np.testing.assert_array_equal(_flat(getattr(got, f))[same],
                                      _flat(getattr(want, f))[same],
                                      err_msg=f)


def test_miss_lanes_take_first_live_row():
    ts = torch_load(str(repo_path("examples", "cornell_indirect.txt")),
                    device="cpu")
    # rays from outside pointing away from the box miss everything
    ro = V3(*(torch.tensor([0.0, 0.0]), torch.tensor([-50.0, -60.0]),
              torch.tensor([0.0, 1.0])))
    rd = V3(*(torch.tensor([0.0, 0.0]), torch.tensor([-1.0, -1.0]),
              torch.tensor([0.0, 0.0])))
    h = closest_hit(ts.data, ts.spec, ro, rd)
    assert not h.hit.any() and (h.obj == 0).all()
    assert torch.isinf(h.t).all()
    assert torch.equal(h.diffuse.x, ts.data.mat_diffuse[0, 0].expand(2))


def test_safe_inv2a_guards_zero():
    a = torch.tensor([0.0, 2.0])
    assert safe_inv2a(a).tolist() == [0.5, 0.25]


def test_closest_hit_showcase_matches_jax():
    """All four materials' rows, spheres seen from inside and outside."""
    path = str(repo_path("examples", "materials_showcase.txt"))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    ro, rd = _rays(2)
    ro = ro * np.float32(0.8) - np.float32([0.0, 0.0, 4.0])
    want = jax_closest_hit(js.data, js.spec,
                           JV3(*(jnp.asarray(ro[:, i]) for i in range(3))),
                           JV3(*(jnp.asarray(rd[:, i]) for i in range(3))))
    got = closest_hit(ts.data, ts.spec,
                      V3(*(torch.from_numpy(ro[:, i]) for i in range(3))),
                      V3(*(torch.from_numpy(rd[:, i]) for i in range(3))))
    same = ((got.obj.numpy() == np.asarray(want.obj))
            & (got.hit.numpy() == np.asarray(want.hit)))
    assert same.mean() >= 0.999, same.mean()
    assert set(got.obj.numpy()[got.hit.numpy()]) == {0, 1, 2, 3}
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(_flat(getattr(got, f))[same],
                                   _flat(getattr(want, f))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    for f in ROW_FIELDS:
        np.testing.assert_array_equal(_flat(getattr(got, f))[same],
                                      _flat(getattr(want, f))[same],
                                      err_msg=f)


@pytest.mark.parametrize("has_range", [True, False])
def test_occluded_matches_jax(has_range):
    """Shadow any-hit, with a squared range (t*t < r^2) and without."""
    path = str(repo_path("examples", "materials_showcase.txt"))
    js = jax_load(path, dtype=jnp.float32)
    ts = torch_load(path, device="cpu")
    ro, rd = _rays(4)
    ro = ro * np.float32(0.8) - np.float32([0.0, 0.0, 4.0])
    sq = np.random.RandomState(4).uniform(0.0, 30.0, N).astype(np.float32)
    want = np.asarray(jax_occluded_v(
        js.data, js.spec, JV3(*(jnp.asarray(ro[:, i]) for i in range(3))),
        JV3(*(jnp.asarray(rd[:, i]) for i in range(3))), jnp.asarray(sq),
        has_range))
    got = occluded_v(ts.data, ts.spec,
                     V3(*(torch.from_numpy(ro[:, i]) for i in range(3))),
                     V3(*(torch.from_numpy(rd[:, i]) for i in range(3))),
                     torch.from_numpy(sq), has_range).numpy()
    assert got.dtype == np.bool_
    assert (got == want).mean() >= 0.999, (got == want).mean()
    assert 0.05 < got.mean() < 0.95
    if has_range:
        # the range only ever lets light through
        unranged = occluded_v(
            ts.data, ts.spec,
            V3(*(torch.from_numpy(ro[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(rd[:, i]) for i in range(3))),
            torch.from_numpy(sq), False).numpy()
        assert (got <= unranged).all() and (got < unranged).any()
