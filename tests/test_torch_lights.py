"""Lit shading in the PyTorch port against the JAX package on the CPU:
light directions for all three light types, the depth-of-field camera,
and shade() for each of the four materials, with its emission and every
child slot.  Inputs come from numpy with a seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import cameras as jcam
from raytrace_tpu.models import lights as jlights
from raytrace_tpu.models import materials as jmat
from raytrace_tpu.ops import intersect as jint
from raytrace_tpu.ops.vec import V3 as JV3
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.models import cameras, lights, materials
from raytrace_tpu_torch.ops import intersect
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene import schema
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import repo_path

SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
N = 2048
# float fields: one f32 rounding per operation on both sides, but XLA and
# PyTorch may order or fuse a few of them differently, and sqrt/sin/cos/
# pow may differ by an ulp
RTOL, ATOL = 1e-5, 1e-6
# a discrete choice (hemisphere flip, total internal reflection, a gate)
# taken on a near-tie may go the other way on a rare lane
MIN_LANES_SAME = 0.999


def scenes(path=SHOWCASE):
    return jax_load(path, dtype=jnp.float32), torch_load(path, device="cpu")


def both_v3(a: np.ndarray):
    """An (N, 3) float32 array as a JAX V3 and a port V3."""
    a = np.ascontiguousarray(a, np.float32)
    return (JV3(*(jnp.asarray(a[:, i]) for i in range(3))),
            V3(*(torch.from_numpy(a[:, i].copy()) for i in range(3))))


def both_words(a: np.ndarray):
    """uint32 words as JAX uint32 and the port's int64 words."""
    return jnp.asarray(a, jnp.uint32), torch.from_numpy(a.astype(np.int64))


def as_np(x) -> np.ndarray:
    """A tensor, JAX array or V3 of either as a float64 (N, k) array."""
    if isinstance(x, tuple):
        return np.stack([as_np(c)[:, 0] for c in x], 1)
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.astype(np.float64).reshape(len(a), -1)


def assert_lanes_close(got, want, mask=None, name=""):
    g, w = as_np(got), as_np(want)
    ok = np.isclose(g, w, rtol=RTOL, atol=ATOL).all(axis=1)
    if mask is not None:
        ok = ok[mask]
    assert ok.size == 0 or ok.mean() >= MIN_LANES_SAME, (name, ok.mean())


def hitrec_from_jax(jh) -> intersect.HitRec:
    """The port's HitRec holding the values of a JAX HitRec."""
    def conv(v):
        if isinstance(v, tuple):
            return V3(*(conv(c) for c in v))
        a = np.asarray(v)
        return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                                else a.copy())
    return intersect.HitRec(*(conv(v) for v in jh))


@pytest.mark.parametrize("light", ["point", "directional", "area"])
def test_light_dir_and_sq_range_matches_jax(light):
    js, ts = scenes()
    li = {"point": 0, "directional": 1, "area": 2}[light]
    lt = ts.spec.light_type[li]
    assert lt == {"point": schema.LIGHT_POINT,
                  "directional": schema.LIGHT_DIRECTIONAL,
                  "area": schema.LIGHT_AREA}[light]
    rs = np.random.RandomState(li)
    jpt, tpt = both_v3(rs.uniform(-4, 4, (N, 3)))
    words = rs.randint(0, 2 ** 32, (2, N), dtype=np.uint64)
    (jk1, tk1), (jk2, tk2) = both_words(words[0]), both_words(words[1])
    jd, jsq, jr = jlights.light_dir_and_sq_range(js.data, lt, li, jpt, jk1,
                                                 jk2, jnp.float32)
    td, tsq, tr = lights.light_dir_and_sq_range(ts.data, lt, li, tpt, tk1,
                                                tk2, torch.float32)
    assert tr == jr == (light != "directional")
    assert td.x.dtype == tsq.dtype == torch.float32
    np.testing.assert_allclose(as_np(td), as_np(jd), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(as_np(tsq), as_np(jsq), rtol=1e-6, atol=1e-7)


def test_dof_project_matches_jax():
    js, ts = scenes()
    assert ts.spec.cam_type == schema.CAM_DEPTH_OF_FIELD
    rs = np.random.RandomState(5)
    pos = rs.uniform(-1, 1, (2, N)).astype(np.float32)
    words = rs.randint(0, 2 ** 32, (2, N), dtype=np.uint64)
    (jk1, tk1), (jk2, tk2) = both_words(words[0]), both_words(words[1])
    jro, jrd = jcam.project(js.data, js.spec, jnp.asarray(pos[0]),
                            jnp.asarray(pos[1]), jk1, jk2)
    tro, trd = cameras.project(ts.data, ts.spec, torch.from_numpy(pos[0]),
                               torch.from_numpy(pos[1]), tk1, tk2)
    np.testing.assert_allclose(as_np(tro), as_np(jro), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(as_np(trd), as_np(jrd), rtol=1e-6, atol=1e-6)
    # the lens moves the origin off the camera position
    assert np.ptp(as_np(tro)[:, 0]) > 1e-3


# a target point per material in the showcase: the Phong floor, then the
# centers of the IndirectPhong, Transparent and Fresnel spheres
TARGETS = {"phong": (0.0, -1.0, -4.0), "indirect": (-2.2, 0.0, -6.0),
           "transparent": (0.0, 0.0, -5.0), "fresnel": (2.2, 0.0, -6.5)}
MATERIALS = {"phong": schema.MAT_PHONG,
             "indirect": schema.MAT_INDIRECT_PHONG,
             "transparent": schema.MAT_TRANSPARENT,
             "fresnel": schema.MAT_FRESNEL}


def _aimed_rays(target, seed):
    """Rays from around the camera toward a jittered target, a quarter
    of them from inside the glass sphere's neighbourhood (exits and
    total internal reflection)."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform([-1.5, -0.5, -1.0], [1.5, 1.5, 1.0], (N, 3))
    ro[: N // 4] = rs.uniform(-0.5, 0.5, (N // 4, 3)) + (0.0, 0.0, -5.0)
    aim = np.asarray(target) + rs.uniform(-0.9, 0.9, (N, 3))
    rd = aim - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro, rd


@pytest.mark.parametrize("depth", [0, 5])
@pytest.mark.parametrize("material", list(MATERIALS))
def test_shade_matches_jax(material, depth):
    """emit and every child slot (ro, rd, sig, weight, live, slot) on rays
    aimed at one material of the showcase; depth 5 is past max_depth."""
    js, ts = scenes()
    rs = np.random.RandomState(11)
    ro, rd = _aimed_rays(TARGETS[material], 3)
    jro, tro = both_v3(ro)
    jrd, trd = both_v3(rd)
    sig = rs.uniform(0.005, 1.0, N).astype(np.float32)
    live = rs.uniform(size=N) < 0.9
    words = rs.randint(0, 2 ** 32, (2, N), dtype=np.uint64)
    (jk1, tk1), (jk2, tk2) = both_words(words[0]), both_words(words[1])

    # both shade the JAX package's hit record, so that the comparison
    # sees shade alone (closest hit has its own test)
    jh = jint.closest_hit(js.data, js.spec, jro, jrd)
    th = hitrec_from_jax(jh)
    same = np.ones(N, bool)
    mat = np.asarray(ts.spec.mat_type)[th.obj.numpy()]
    aimed = th.hit.numpy() & (mat == MATERIALS[material])
    assert aimed.mean() > 0.3, aimed.mean()

    jemit, jkids = jmat.shade(js.data, js.spec, jro, jrd, jh,
                              jnp.asarray(sig), jnp.asarray(live), jk1, jk2,
                              depth)
    temit, tkids = materials.shade(ts.data, ts.spec, tro, trd, th,
                                   torch.from_numpy(sig),
                                   torch.from_numpy(live), tk1, tk2, depth)
    assert_lanes_close(temit, jemit, same, "emit")
    assert [c.slot for c in tkids] == [c.slot for c in jkids]
    if depth > ts.spec.max_depth:
        assert tkids == []
        np.testing.assert_array_equal(as_np(temit), as_np(th.ambient))
        return
    assert [c.slot for c in tkids] == list(range(ts.spec.children_per_ray))
    n_live = 0
    for tc, jc in zip(tkids, jkids):
        tl, jl = tc.live.numpy(), np.asarray(jc.live)
        assert (tl == jl)[same].mean() >= MIN_LANES_SAME, tc.slot
        both = same & tl & jl
        n_live += both.sum()
        for f in ("ro", "rd", "sig", "weight"):
            assert_lanes_close(getattr(tc, f), getattr(jc, f), both,
                               f"slot {tc.slot} {f}")
    assert n_live > 0
    # direct light reached some aimed lanes
    assert (as_np(temit)[aimed & live] > as_np(th.ambient)[aimed & live]
            ).any()
