"""Pixel-sharded rendering, the sharded fitting step and the mesh of the
port (``raytrace_tpu_torch.parallel``, ``optim.make_sharded_step``) on
gloo groups of 2 and 4 ranks on the CPU: twins of tests/test_parallel.py.
The sharded image must equal the one-process image to the bit, and the
sharded step the one-process step (loss to 1e-12, gradients to 1e-9).
The JAX package's tests use the reference snapshot's scene, which is not
in the repo; these use ``examples/cornell_indirect.txt``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.optim import make_sharded_step as jax_sharded_step
from raytrace_tpu.parallel.mesh import make_mesh as jax_mesh
from raytrace_tpu.scene.builder import load_scene_file as jax_load
from raytrace_tpu_torch.optim import loss_and_grad
from raytrace_tpu_torch.parallel import mesh as meshlib
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene.builder import load_scene_file
from raytrace_tpu_torch.scene.procedural import make_sphere_field
from raytrace_tpu_torch.scene.schema import SceneData

import test_torch_group as group
from conftest import REPO_ROOT

CORNELL = str(REPO_ROOT / "examples" / "cornell_indirect.txt")


def _scene(w, h, dtype=torch.float32, **spec):
    sc = load_scene_file(CORNELL, device="cpu", dtype=dtype)
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=w, height=h, **spec))


def _sharded(tmp_path, sc, seed, spp, k=2):
    outs = group.run_group(group.sharded_render_job, k, sc, seed, spp,
                           out_dir=tmp_path)
    for other in outs[1:]:
        np.testing.assert_array_equal(other, outs[0])
    return outs[0]


def test_sharded_render_bit_identical(tmp_path):
    sc = _scene(16, 16)
    np.testing.assert_array_equal(_sharded(tmp_path, sc, 5, 4),
                                  render_image(sc, seed=5, spp=4))


@pytest.mark.parametrize("kind", ["sharded", "ring"])
@pytest.mark.parametrize("files", ["one path", "a path per rank"])
def test_sharded_checkpoint_resume(kind, files, tmp_path):
    """A checkpointed render on two ranks, stopped on every rank after its
    first launch group (one sample each) and resumed in a new group,
    equals the uncheckpointed render to the bit on both ranks.  Rank 0
    alone writes the file (one file, no temp file left) and reads it back
    for both, whether the ranks share its path or not (a path per rank:
    rank 1's stays empty); a resume with another seed raises the same
    ``ValueError`` on both ranks, each naming its path."""
    sc = make_sphere_field(70, width=4, height=4, antialias=1,
                           mix_materials=False, device="cpu")
    dirs = ["ck", "ck"] if files == "one path" else ["ck0", "ck1"]
    for d in (*dirs, "a", "b"):
        (tmp_path / d).mkdir(exist_ok=True)
    paths = [str(tmp_path / d / "state.npz") for d in dirs]
    first = group.run_group(
        group.checkpoint_job, 2, kind, sc, 4, paths,
        [(3, False, False), (3, True, True)], out_dir=tmp_path / "a")
    with np.load(paths[0]) as state:
        assert int(state["s_done"]) == 1
    resumed = group.run_group(
        group.checkpoint_job, 2, kind, sc, 4, paths,
        [(3, True, False), (4, True, False)], out_dir=tmp_path / "b")
    for r, ((full, stopped), (again, other_seed)) in enumerate(
            zip(first, resumed)):
        assert full[0] == "image" and full[1].std() > 0
        assert stopped == ("stopped", [0.25, 0.5])
        assert again[0] == "image"
        np.testing.assert_array_equal(again[1], full[1])
        assert other_seed == ("refused", f"checkpoint {paths[r]} was written "
                              f"for a different render config; refusing to "
                              f"mix")
    files_left = sorted(str(f.relative_to(tmp_path))
                        for f in tmp_path.glob("ck*/*"))
    assert files_left == ["ck/state.npz" if files == "one path"
                          else "ck0/state.npz"]


def test_sharded_render_nondivisible_pixels(tmp_path):
    """5x5 = 25 pixels over 4 ranks: the padding path."""
    sc = _scene(5, 5)
    np.testing.assert_array_equal(_sharded(tmp_path, sc, 2, 2, k=4),
                                  render_image(sc, seed=2, spp=2))


def test_sharded_render_large_scene_scan_path(tmp_path):
    """More than 64 objects: the scan of the unified table, per rank."""
    sc = make_sphere_field(80, width=16, height=16, device="cpu")
    sc = dataclasses.replace(sc, spec=dataclasses.replace(sc.spec,
                                                          max_depth=1))
    assert sc.spec.n_objects > 64
    np.testing.assert_array_equal(_sharded(tmp_path, sc, 2, 2),
                                  render_image(sc, seed=2, spp=2))


def test_sharded_grads_match_psum(tmp_path):
    """float64, max_depth 1, 8x4 pixels, 2 samples: the 2-rank step (each
    rank's loss_and_grad on its pixel shard, then the sums) against the
    one-process step and against the JAX package's make_sharded_step."""
    sc = _scene(8, 4, torch.float64, max_depth=1)
    w, h = 8, 4
    pix = torch.arange(w * h)
    px, py, sids = pix % w, pix // w, torch.arange(2)
    target = torch.zeros((w * h, 3), dtype=torch.float64)
    loss0, g0 = loss_and_grad(sc.data, sc.spec, px, py, sids, 3, target)
    outs = group.run_group(group.sharded_step_job, 2, sc.data, sc.spec, px,
                           py, sids, 3, target, out_dir=tmp_path)
    names = [f.name for f in dataclasses.fields(SceneData)]
    moved = 0
    for loss1, g1 in outs:
        np.testing.assert_allclose(float(loss1), float(loss0), rtol=1e-12)
        for n in names:
            np.testing.assert_allclose(getattr(g1, n).numpy(),
                                       getattr(g0, n).numpy(), rtol=1e-9,
                                       atol=1e-10, err_msg=n)
            moved += bool(getattr(g1, n).abs().max() > 0)
    assert moved >= 2 * 4

    js = jax_load(CORNELL, dtype=jnp.float64)
    js = dataclasses.replace(js, spec=dataclasses.replace(
        js.spec, width=w, height=h, max_depth=1))
    step = jax_sharded_step(js.spec, jax_mesh(), seed=3)
    jloss, jg = step(js.data, jnp.asarray(px.numpy(), jnp.uint32),
                     jnp.asarray(py.numpy(), jnp.uint32),
                     jnp.arange(2, dtype=jnp.uint32),
                     jnp.zeros((w * h, 3), jnp.float64))
    loss1, g1 = outs[0]
    np.testing.assert_allclose(float(loss1), float(jloss), rtol=1e-12)
    for n in names:
        np.testing.assert_allclose(getattr(g1, n).numpy(),
                                   np.asarray(getattr(jg, n)), rtol=1e-9,
                                   atol=1e-10, err_msg=n)


def test_mesh_shapes(tmp_path):
    """A 4-rank group: the flat mesh and the ("dcn", "ici") ones, and each
    collective the renders use; without a group, one rank."""
    m = meshlib.make_mesh("cpu")
    assert (m.ranks, m.rank, m.shape) == (1, 0, {"d": 1})
    assert meshlib.make_mesh_2d(device="cpu").shape == {"dcn": 1, "ici": 1}
    with pytest.raises(ValueError, match="do not split"):
        meshlib.make_mesh_2d(2, device="cpu")
    outs = group.run_group(group.mesh_job, 4, out_dir=tmp_path)
    base = torch.arange(3, dtype=torch.float64)
    for r, o in enumerate(outs):
        assert (o["ranks"], o["rank"], o["shape"]) == (4, r, {"d": 4})
        assert o["shape_2d"] == [{"dcn": 1, "ici": 4}, {"dcn": 2, "ici": 2},
                                 {"dcn": 4, "ici": 1}]
        assert torch.equal(o["gathered"],
                           torch.stack([base + 10 * q for q in range(4)]))
        assert torch.equal(o["summed"], 4 * base + 60)
        assert torch.equal(o["broadcast"], base)
        left = base + 10 * ((r - 1) % 4)
        assert torch.equal(o["shifted"][0], left)
        assert torch.equal(o["shifted"][1], left.to(torch.int32))
        assert torch.equal(o["replicated"], outs[0]["replicated"])
    assert not torch.distributed.is_initialized()
