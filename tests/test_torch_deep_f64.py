"""What the port renders on CPU tensors through the kernels' plain
version: a fan-out tree whose DFS stack exceeds 64 entries (on the card,
the tree kernel's 128-entry stack), and float64 scenes (beyond the
kernels' slice), each against the JAX package's jnp wavefront
``radiance_v``.  The JAX side runs eagerly (``jax.disable_jit``): its
compiled programs for these scenes take minutes to build on the CPU."""

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
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.scene import dsl as tdsl
from raytrace_tpu_torch.scene.builder import build_scene as torch_build
from raytrace_tpu_torch.scene.builder import load_scene_file as torch_load

from conftest import repo_path
from test_torch_kernel_work import INDIRECT
from test_torch_megakernel import assert_radiance_close

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))

# a 65-sample IndirectPhong sphere beside a Phong floor at max_depth 0, on
# a 4x4 image: m = 65, a DFS stack of 65 entries, 66 nodes per lane
DEEP = INDIRECT.replace("SAMPLES", "65").replace(
    "width: 32 height: 32", "width: 4 height: 4")


def _with_depth(scene, max_depth):
    return dataclasses.replace(scene, spec=dataclasses.replace(
        scene.spec, max_depth=max_depth))


def _image_lanes(spec, spp):
    """Every pixel of the image, aa samples 0..spp-1, lens sample 0."""
    n = spec.width * spec.height
    pix = np.repeat(np.arange(n) % spec.width, spp)
    piy = np.repeat(np.arange(n) // spec.width, spp)
    return pix, piy, np.tile(np.arange(spp), n), np.zeros(n * spp, np.int64)


def _jax_radiance(js, lanes, seed):
    """The JAX package's jnp wavefront on the lanes, run eagerly."""
    with jax.disable_jit():
        ro, rd, k1, k2 = jint.primary_rays(
            js.data, js.spec, *(jnp.asarray(a, jnp.uint32) for a in lanes),
            seed)
        rad = jint.radiance_v(js.data, js.spec, ro, rd, k1, k2)
        return np.stack([np.asarray(c, np.float64) for c in rad])


def _torch_radiance(ts, lanes, seed):
    rad = megakernel.radiance_lanes(
        ts.data, ts.spec, *(torch.from_numpy(a.astype(np.int64))
                            for a in lanes), seed)
    return torch.stack(list(rad)).double().numpy()


def test_deep_tree_renders_on_cpu_and_matches_jax():
    """A DFS stack of 65 entries (the tree kernel's 128-entry instance on
    the card): on CPU tensors radiance_lanes takes the plain walk and
    agrees with the JAX package's jnp path (float32, the port's per-lane
    rule)."""
    ts = _with_depth(torch_build(tdsl.parse(DEEP), device="cpu"), 0)
    js = _with_depth(jax_build(jdsl.parse(DEEP), dtype=jnp.float32), 0)
    assert integrator.tree_loop_stack(ts.spec) == (65, 2, 66, 65)
    assert megakernel.usable(ts.data, ts.spec)
    assert megakernel.tree_instance(65) == 128
    lanes = _image_lanes(ts.spec, 2)
    before = dict(megakernel.LAUNCHES)
    got = _torch_radiance(ts, lanes, 2)
    assert megakernel.LAUNCHES == before
    want = _jax_radiance(js, lanes, 2)
    assert got.shape == want.shape == (3, 32) and got.max() > 0
    assert_radiance_close(got, want)


def test_render_image_renders_deep_tree():
    """The image loop on CPU tensors takes the same scene (the CLI's
    path; the scene language cannot set max_depth 0): each pixel is the
    mean of its lanes."""
    ts = _with_depth(torch_build(tdsl.parse(DEEP), device="cpu"), 0)
    img = integrator.render_image(ts, seed=2, spp=2)
    lanes = _image_lanes(ts.spec, 2)
    want = _torch_radiance(ts, lanes, 2).reshape(3, 4, 4, 2).mean(axis=3)
    # the image's rows are y, counted from the bottom row, as the lanes'
    np.testing.assert_allclose(img.transpose(2, 0, 1), want,
                               rtol=1e-6)
    assert np.isfinite(img).all() and img.max() > 0


@pytest.mark.parametrize("path", [CORNELL, SHOWCASE],
                         ids=["cornell", "showcase"])
def test_f64_lanes_match_jax_wavefront(path):
    """tests/test_tree.py's float64 parity (the DFS against the wavefront
    at max_depth 2, to roundoff) with the port's radiance_lanes on CPU
    tensors in place of the JAX package's DFS: the linear chain of
    cornell and the showcase's tree (all four materials, three light
    types, depth of field)."""
    ts = _with_depth(torch_load(path, device="cpu", dtype=torch.float64), 2)
    js = _with_depth(jax_load(path, dtype=jnp.float64), 2)
    assert not megakernel.usable(ts.data, ts.spec)
    rs = np.random.RandomState(3)
    n = 256
    lanes = (rs.randint(0, ts.spec.width, n), rs.randint(0, ts.spec.height, n),
             rs.randint(0, 4, n), rs.randint(0, ts.spec.cam_samples, n))
    got = _torch_radiance(ts, lanes, 5)
    want = _jax_radiance(js, lanes, 5)
    assert got.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
