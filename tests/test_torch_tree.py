"""The fan-out DFS of the PyTorch port against the JAX package on the
CPU: the static schedule, one node visit with its child routing and RNG
keys, and the whole walk on the materials showcase."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.render import integrator as jint
from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import build_scene as jax_build
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.render import integrator
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import repo_path
from test_torch_lights import as_np
from test_torch_megakernel import assert_radiance_close

SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))

# a Phong mirror floor beside a one-sample IndirectPhong sphere: two child
# slots (reflect 0, indirect 1), at most one live, so m = 1
PHONG_INDIRECT = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.5,0.5,0.5)
        specular: rgb(0.4,0.4,0.4) exponent: 8 ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: IndirectPhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0.2,0.2,0.2)
        samples: 1 } }
  ]
  lights: [ { model: PointLight { location: (2, 3, -1) } color: rgb(1,1,1) } ]
  camera: SimplePerspectiveCamera new((0,0,0), (0,-0.2,-1), (0,1,0), 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 32 height: 32 antialias: 2 }
}"""


def _depth(scene, d):
    return dataclasses.replace(scene, spec=dataclasses.replace(scene.spec,
                                                               max_depth=d))


def _lanes(spec, n, seed):
    rs = np.random.RandomState(seed)
    return (rs.randint(0, spec.width, n), rs.randint(0, spec.height, n),
            rs.randint(0, 4, n), rs.randint(0, spec.cam_samples, n))


def _primary(js, ts, lanes, seed):
    j = jint.primary_rays(js.data, js.spec,
                          *(jnp.asarray(a, jnp.uint32) for a in lanes), seed)
    t = integrator.primary_rays(ts.data, ts.spec,
                                *(torch.from_numpy(a.astype(np.int64))
                                  for a in lanes), seed)
    return j, t


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_schedule_matches_jax(m):
    """_dfs_schedule, tree_loop_stack and tree_nodes equal the JAX
    package's exactly."""
    for levels in range(1, 7):
        assert integrator._dfs_schedule(m, levels) == jint._dfs_schedule(
            m, levels)[0]
        n_indirect = m if m > 2 else 0
        spec = dataclasses.replace(
            torch_load(SHOWCASE, device="cpu").spec, max_depth=levels - 2,
            has_reflect=m > 1, has_refract=m > 1, n_indirect=n_indirect)
        assert integrator.tree_loop_stack(spec) == jint.tree_loop_stack(spec)
        assert integrator.tree_nodes(spec) == jint.tree_nodes(spec)
        # the closed form against the JAX package's simulated walk
        depths, cap = jint._dfs_schedule(*integrator.tree_loop_stack(spec)[:2])
        assert (len(depths), cap) == integrator.tree_loop_stack(spec)[2:]


@pytest.mark.parametrize("scene", ["showcase", "phong+indirect"])
def test_tree_loop_node_matches_jax(scene):
    """One node visit at depth 0: the contribution and every routed child
    entry; the children's RNG keys equal the JAX package's bit for bit,
    derived from the original slot (reflect 0, refract 1, indirect 2 and 3
    in the showcase; reflect 0, indirect 1 beside a Phong floor)."""
    if scene == "showcase":
        js = jax_load(SHOWCASE, dtype=jnp.float32)
        ts = torch_load(SHOWCASE, device="cpu")
    else:
        js = jax_build(jdsl.parse(PHONG_INDIRECT), dtype=jnp.float32)
        ts = torch_build(tdsl.parse(PHONG_INDIRECT), device="cpu")
        assert (ts.spec.children_per_ray, ts.spec.max_live_children) == (2, 1)
    m = integrator.tree_loop_stack(ts.spec)[0]
    lanes = _lanes(ts.spec, 1024, 2)
    (jro, jrd, jk1, jk2), (tro, trd, tk1, tk2) = _primary(js, ts, lanes, 3)
    np.testing.assert_array_equal(tk1.numpy(), np.asarray(jk1))
    one_j, one_t = jnp.ones_like(jro.x), torch.ones_like(tro.x)
    jentry = jint.tree_loop_entry(jro, jrd, one_j, type(jro)(one_j, one_j,
                                                            one_j),
                                  one_j, jk1, jk2, jnp.float32)
    tentry = integrator.tree_loop_entry(tro, trd, one_t,
                                        type(tro)(one_t, one_t, one_t),
                                        one_t, tk1, tk2, torch.float32)
    jc, jvirt = jint.tree_loop_node(js.data, js.spec, m, jentry, 0)
    tc, tvirt = integrator.tree_loop_node(ts.data, ts.spec, m, tentry, 0)
    assert len(tvirt) == len(jvirt) == m
    assert_radiance_close(as_np(tc).T, as_np(jc).T)
    n_live = 0
    for tv, jv in zip(tvirt, jvirt):
        tl, jl = tv[10].numpy() > 0.5, np.asarray(jv[10]) > 0.5
        assert (tl == jl).mean() >= 0.999
        both = tl & jl
        n_live += both.sum()
        for c in (11, 12):  # k1, k2
            np.testing.assert_array_equal(
                tv[c].numpy()[both], np.asarray(jv[c]).astype(np.int64)[both])
        for c in range(10):
            # the kernel rule's share of lanes (a near-grazing refraction
            # amplifies an ulp of the hit point)
            close = np.isclose(tv[c].numpy()[both], np.asarray(jv[c])[both],
                               rtol=1e-4, atol=1e-5)
            assert close.mean() >= 0.99, (c, close.mean())
    assert n_live > 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_showcase_tree_loop_matches_jax(dtype):
    """The whole DFS on the showcase (all four materials, three light
    types, depth of field) at max_depth 2 (15 nodes, m = 2) against the
    JAX package's radiance_tree_loop_v, jitted on the CPU.  float32
    follows the port's kernel tolerance; float64 agrees to roundoff."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    js = _depth(jax_load(SHOWCASE, dtype=jd), 2)
    ts = _depth(torch_load(SHOWCASE, device="cpu", dtype=td), 2)
    assert integrator.tree_loop_stack(ts.spec) == (2, 4, 15, 4)
    lanes = _lanes(ts.spec, 1024, 5)

    @jax.jit
    def want_fn(data, pix, piy, aa, cam):
        ro, rd, k1, k2 = jint.primary_rays(data, js.spec, pix, piy, aa, cam, 5)
        return jint.radiance_tree_loop_v(data, js.spec, ro, rd, k1, k2)

    want = want_fn(js.data, *(jnp.asarray(a, jnp.uint32) for a in lanes))
    ro, rd, k1, k2 = integrator.primary_rays(
        ts.data, ts.spec, *(torch.from_numpy(a.astype(np.int64))
                            for a in lanes), 5)
    got = integrator.radiance_tree_loop_v(ts.data, ts.spec, ro, rd, k1, k2)
    assert got.x.dtype == td
    g, w = as_np(got).T, as_np(want).T
    assert g.max() > 0
    if dtype == "float32":
        assert_radiance_close(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-14)
