"""Gradients through the port's object-sharded ring
(``raytrace_tpu_torch.parallel.ring``) against the port's dense closest
hit and against the JAX package's ``jax.grad``.

The contract is the JAX one: every rank calls
``make_ring_intersector(spec, mesh)(data, ro, rd)``, takes the same loss of
the gathered ``(t, obj, hit)`` and calls ``backward()``; each rank's
gradients in ``prim_p``, ``prim_q``, ``ro`` and ``rd`` are then the dense
closest hit's.  Under a ring context each rank takes a loss of its own
lanes' records from ``ring_closest_hit``, and each rank's gradients in the
per-object leaves (geometry and materials, through the rows' ring) are
those of the sum of the ranks' losses.  The field and rays are
tests/test_ring.py's (106 objects, 512 rays, seed 5); the ring runs as
gloo groups of 2 and 4 ranks (k = 1, the dense scan's gradient, needs
none).

Float64 is held to ``rtol 1e-9, atol 1e-10``, against the port's dense
gradient and JAX's ``jax.grad`` through its own ring.  Float32 is held by
the port's gradient rule, ``rtol 1e-5, atol 1e-6``, with 1e-6 of the
leaf's largest gradient added to the ``atol``: at k >= 2 the ranks sum a
leaf's gradient in another order, and a plane normal's component along
the plane, 0 in float64, is a difference of partial sums of some 1e3-1e4
that rounds to an ulp of them (measured 1.5e-3 at k = 2 and 4).  JAX's
float32 reference is its dense ``closest_hit`` evaluated op by op
(``jax.disable_jit()``): compiled, JAX's float32 gradient parts from its
own op-by-op gradient on 47 of the 318 ``prim_p`` entries, by up to 3.6%
relative (XLA rewrites the arithmetic; its float32 gradient is then the
closer to float64), and the port's gradient equals the op-by-op one.

The ring's round loop (``ring_radiance``) is forward only and must refuse
a scene that wants a gradient, and so must the render's entry point
(``radiance_lanes``) under a ring context on the card.  The tests marked
``cuda`` hold the ring's gradients on the card, where K5 and ``ring_rows``
carry the forwards, to the dense ones, and that refusal."""

import contextlib
import dataclasses
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import intersect as jax_intersect
from raytrace_tpu.ops import vec as jax_vec
from raytrace_tpu.parallel import ring as jax_ring
from raytrace_tpu.parallel.mesh import make_mesh as jax_mesh
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.ops import _build, intersect
from raytrace_tpu_torch.parallel import ring
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.render import ring_shade
from raytrace_tpu_torch.render.integrator import lane_ids
from raytrace_tpu_torch.scene.procedural import make_sphere_field

import test_torch_group as group
from test_torch_ring import _rays

N_RAYS = 512
TOL = {"float64": dict(rtol=1e-9, atol=1e-10),
       "float32": dict(rtol=1e-5, atol=1e-6)}
T_LEAVES = ("prim_p", "prim_q", "ro", "rd")


def _inputs(dtype: str, device="cpu"):
    ts = make_sphere_field(100, device=device, dtype=getattr(torch, dtype))
    ro, rd = (torch.from_numpy(a).to(device=device, dtype=ts.data.dtype)
              for a in _rays(N_RAYS, 5))
    return ts, ro, rd


def _dense_t_grads(ts, ro, rd):
    """The dense closest hit's gradients of the t loss."""
    return group.grads_of(group.grad_losses(ts.data, ts.spec, ro, rd)["t"])


def _dense_rec_grads(ts, ro, rd):
    """The dense closest hit's gradients of the records' loss in every
    per-object leaf."""
    return dict(zip(ring.OBJECT_LEAVES, group.grads_of(
        group.grad_losses(ts.data, ts.spec, ro, rd)["records"])))


@lru_cache(maxsize=None)
def _jax_t_grads(dtype: str):
    """``jax.grad`` of the same loss in the JAX package, as numpy: in
    float64 through its ring (``make_ring_intersector``, jitted, on its
    8-device CPU mesh); in float32 through its dense ``closest_hit`` op by
    op (some 20 s; the ring op by op takes over 15 minutes)."""
    js = jax_field(100, dtype=getattr(jnp, dtype))
    ro, rd = (jnp.asarray(a, getattr(jnp, dtype)) for a in _rays(N_RAYS, 5))
    w = 1.0 + jnp.arange(N_RAYS, dtype=ro.dtype) / N_RAYS
    if dtype == "float64":
        fn = jax_ring.make_ring_intersector(js.spec, jax_mesh())
    else:
        def fn(data, o, d):
            rec = jax_intersect.closest_hit(data, js.spec, jax_vec.splat(o),
                                            jax_vec.splat(d))
            return rec.t, rec.obj, rec.hit

    def loss(p, q, o, d):
        t, _, hit = fn(dataclasses.replace(js.data, prim_p=p, prim_q=q), o, d)
        return jnp.sum(w * jnp.where(hit, t, 0.0))

    with (jax.disable_jit() if dtype == "float32"
          else contextlib.nullcontext()):
        grads = jax.grad(loss, argnums=(0, 1, 2, 3))(js.data.prim_p,
                                                     js.data.prim_q, ro, rd)
    return [np.asarray(g) for g in grads]


def _assert_grads_close(got, want, dtype: str, label: str, names=T_LEAVES):
    """The gradient rule of the module's docstring, leaf by leaf."""
    for name, g, w in zip(names, got, want):
        g = g.detach().cpu().numpy() if isinstance(g, torch.Tensor) else g
        w = w.detach().cpu().numpy() if isinstance(w, torch.Tensor) else w
        assert np.isfinite(g).all(), (label, name)
        tol = dict(TOL[dtype])
        if dtype == "float32":
            tol["atol"] += 1e-6 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{label}: {name}")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ring_intersector_grads(dtype, k, tmp_path):
    """Every rank's gradients of one loss of the gathered t equal the
    port's dense closest-hit gradients and JAX's."""
    ts, ro, rd = _inputs(dtype)
    if k == 1:
        ranks = [group.ring_grad_job(ts.data, ts.spec, ro, rd)]
    else:
        ranks = group.run_group(group.ring_grad_job, k, ts.data, ts.spec,
                                ro, rd, out_dir=tmp_path)
    dense = _dense_t_grads(ts, ro, rd)
    assert all(float(g.abs().sum()) > 0 for g in dense)
    for r, got in enumerate(ranks):
        _assert_grads_close(got, dense, dtype, f"rank {r} vs dense")
        _assert_grads_close(got, _jax_t_grads(dtype), dtype,
                            f"rank {r} vs JAX")


@pytest.mark.parametrize("k,dtype", [(1, "float64"), (2, "float64"),
                                     (2, "float32")])
def test_ring_closest_hit_grads_reach_materials(k, dtype, tmp_path):
    """Each rank's lanes through ``ring_closest_hit`` under a ring context:
    every rank's gradients in the per-object leaves (through t, the
    normal and the rows' material values) equal the dense path's on all
    the lanes."""
    ts, ro, rd = _inputs(dtype)
    if k == 1:
        ranks = [group.ring_rec_grad_job(ts.data, ts.spec, ro, rd)]
    else:
        ranks = group.run_group(group.ring_rec_grad_job, k, ts.data, ts.spec,
                                ro, rd, out_dir=tmp_path)
    want = _dense_rec_grads(ts, ro, rd)
    assert all(float(g.abs().sum()) > 0 for g in want.values())
    for r, got in enumerate(ranks):
        _assert_grads_close([got[n] for n in want], list(want.values()),
                            dtype, f"rank {r}", names=list(want))


def test_ring_radiance_refuses_grad():
    """The ring's round loop is forward only: a scene whose leaves want a
    gradient (an object's, which the ring shards, or the camera's) is
    refused, naming the ROADMAP item; without grad mode it renders."""
    ts = make_sphere_field(100, width=4, height=4, mix_materials=False,
                           device="cpu")
    pix = torch.arange(16)
    lanes = lane_ids(pix % 4, pix // 4, torch.arange(1), ts.spec.cam_samples)
    mesh = make_mesh("cpu")
    for name in ("mat_diffuse", "cam_position"):
        wants = dataclasses.replace(ts.data, **{
            name: getattr(ts.data, name).clone().requires_grad_(True)})
        with ring.ring_context(wants, ts.spec, mesh) as stripped:
            with pytest.raises(NotImplementedError, match="item 13"):
                ring.ring_radiance(intersect.ring_ctx(), stripped, ts.spec,
                                   *lanes, 0,
                                   step=ring_shade.ring_shade_reference)
            with torch.no_grad():
                acc = ring.ring_radiance(
                    intersect.ring_ctx(), stripped, ts.spec, *lanes, 0,
                    step=ring_shade.ring_shade_reference)
        assert torch.isfinite(torch.stack(list(acc))).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_ring_grads_on_card(cuda_device):
    """k = 1 on the card: the forwards are K5's and ``ring_rows``'
    launches, and the gradients equal the dense path's (both backwards the
    plain versions under autograd) by the float32 rule."""
    ts, ro, rd = _inputs("float32", cuda_device)
    mesh = make_mesh(cuda_device)
    before = dict(_build.LAUNCHES)
    got = group.ring_grad_job(ts.data, ts.spec, ro, rd, mesh)
    assert (_build.LAUNCHES[_build.KERNEL_SCAN]
            == before[_build.KERNEL_SCAN] + 1)
    _assert_grads_close(got, _dense_t_grads(ts, ro, rd), "float32",
                        "the ring on the card")
    before = dict(_build.LAUNCHES)
    got = group.ring_rec_grad_job(ts.data, ts.spec, ro, rd, mesh)
    assert _build.LAUNCHES["ring_rows"] == before["ring_rows"] + 1
    assert (_build.LAUNCHES[_build.KERNEL_SCAN]
            == before[_build.KERNEL_SCAN] + 1)
    want = _dense_rec_grads(ts, ro, rd)
    _assert_grads_close([got[n] for n in want], list(want.values()),
                        "float32", "the rows' ring on the card",
                        names=list(want))


@pytest.mark.cuda
def test_radiance_lanes_ring_refuses_grad_on_card(cuda_device):
    """The render's entry point refuses too: under a ring context on the
    card, ``radiance_lanes`` raises, naming the ROADMAP item, where a
    camera leaf, an object's or both want a gradient (the kernel's forward
    runs with grad mode off, so the refusal comes before it); without
    grad mode the ring kernels render."""
    from raytrace_tpu_torch.render import megakernel

    ts = make_sphere_field(100, width=4, height=4, mix_materials=False,
                           device=cuda_device)
    pix = torch.arange(16, device=cuda_device)
    lanes = lane_ids(pix % 4, pix // 4,
                     torch.arange(1, device=cuda_device), ts.spec.cam_samples)
    mesh = make_mesh(cuda_device)
    for names in (("cam_position",), ("mat_diffuse",),
                  ("cam_position", "mat_diffuse")):
        wants = dataclasses.replace(ts.data, **{
            n: getattr(ts.data, n).clone().requires_grad_(True)
            for n in names})
        with ring.ring_context(wants, ts.spec, mesh) as stripped:
            with pytest.raises(NotImplementedError, match="item 13"):
                megakernel.radiance_lanes(stripped, ts.spec, *lanes, 0)
            with torch.no_grad():
                acc = megakernel.radiance_lanes(stripped, ts.spec, *lanes, 0)
        assert torch.isfinite(torch.stack(list(acc))).all(), names
