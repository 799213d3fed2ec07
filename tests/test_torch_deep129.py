"""A 129-sample IndirectPhong sphere beside a Phong floor at max_depth 0
(a DFS stack of 129 entries, 130 nodes a lane: the tree kernel's
256-entry stack on the card) through the port's radiance_lanes on CPU
tensors, against the JAX package's jnp wavefront ``radiance_v``, run
eagerly.  A file of its own, so that the test gets a worker of its own."""

import jax
import jax.numpy as jnp
import numpy as np

from raytrace_tpu.render import integrator as jint
from raytrace_tpu.scene import dsl as jdsl
from raytrace_tpu.scene.builder import build_scene as jax_build
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build

from test_torch_deep_f64 import (_image_lanes, _torch_radiance,
                                 _with_depth)
from test_torch_kernel_work import INDIRECT
from test_torch_megakernel import assert_radiance_close

DEEP129 = INDIRECT.replace("SAMPLES", "129").replace(
    "width: 32 height: 32", "width: 2 height: 2")


def test_129_sample_tree_matches_jax(monkeypatch):
    """The port's per-lane rule (99% of lanes within 1e-4 max(1, |ref|),
    means within 1e-3) on every lane of a 2x2 image at 4 spp.  The
    floor's mirror slot makes 130 child slots for at most 129 live
    children, so the wavefront compacts them, one gather per (slot,
    child) pair; with RAYTRACE_TPU_NO_COMPACTION it runs the 130 slots
    as they are.  No lane has more than 129 live slots (the sphere's 129
    or the floor's one), and each child keeps the stream of its slot, so
    the children and their sum are the same; eagerly the compaction
    alone takes minutes."""
    monkeypatch.setenv("RAYTRACE_TPU_NO_COMPACTION", "1")
    ts = _with_depth(torch_build(tdsl.parse(DEEP129), device="cpu"), 0)
    js = _with_depth(jax_build(jdsl.parse(DEEP129), dtype=jnp.float32), 0)
    assert integrator.tree_loop_stack(ts.spec) == (129, 2, 130, 129)
    assert megakernel.usable(ts.data, ts.spec)
    assert megakernel.tree_instance(129) == 256
    lanes = _image_lanes(ts.spec, 4)
    before = dict(megakernel.LAUNCHES)
    got = _torch_radiance(ts, lanes, 5)
    assert megakernel.LAUNCHES == before
    with jax.disable_jit():
        ro, rd, k1, k2 = jint.primary_rays(
            js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes),
            5)
        rad = jint.radiance_v(js.data, js.spec, ro, rd, k1, k2)
    want = np.stack([np.asarray(c, np.float64) for c in rad])
    assert got.shape == want.shape == (3, 16) and got.max() > 0
    assert_radiance_close(got, want)
