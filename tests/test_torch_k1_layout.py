"""The small-scene layout of the port's render kernels, checked on the
CPU: ``pack_scene``'s rows with their precomputed column, and a numpy
model of the kernels' closest hit over those rows against the plain
``closest_hit``, exact ties and grazing rays included.  The kernels
themselves: the ``cuda``-marked test, and ``chip_smoke.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.ops.intersect import _object_t, closest_hit
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene import dsl, schema
from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file

from chip_smoke import TIES, ambient_ids
from conftest import repo_path

F32 = np.float32
CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))


# TIES (chip_smoke.py): exact ties between coincident planes, and between
# a sphere and a plane on the axis rays below; object k's ambient color is
# (k + 1) / 16 in red


def _scene(name):
    if name == "ties":
        return build_scene(dsl.parse(TIES), device="cpu")
    return load_scene_file(CORNELL if name == "cornell" else SHOWCASE,
                           device="cpu")


def _rows(buf, spec):
    return buf[24 + 16 * spec.n_lights:].reshape(-1, 24)


@pytest.mark.parametrize("name", ["cornell", "showcase", "ties"])
def test_pack_scene_precomputes_the_plain_roundings(name):
    """Column 22 holds a sphere's float32 r * r, and a plane's p.n with the
    bits of ops/intersect.py::_object_t's: from the origin along +x that
    function's t is p.n / n_x, which the column divided by n_x must give.
    A second pass moves every object and gives every plane n_x = 1, where
    the division is exact and the column must equal t itself."""
    sc = _scene(name)
    data, spec = sc.data, sc.spec
    ro = V3(*(torch.zeros(1) for _ in range(3)))
    rd = V3(torch.ones(1), torch.zeros(1), torch.zeros(1))
    a = torch.ones(1)
    rs = np.random.RandomState(5)
    q = data.prim_q.clone()
    q[:, 1:] = torch.from_numpy(rs.normal(0, 2, (q.shape[0], 2)).astype(F32))
    q[:, 0] = 1.0
    moved = dataclasses.replace(
        data, prim_q=torch.where(torch.tensor(
            [t == schema.SHAPE_PLANE for t in spec.shape_type])[:, None],
            q, data.prim_q),
        prim_p=data.prim_p + torch.from_numpy(
            rs.normal(0, 3, tuple(data.prim_p.shape)).astype(F32)))
    n_planes = 0
    for variant in (data, moved):
        rows = _rows(megakernel.pack_scene(variant, spec), spec)
        for r, i in zip(rows, spec.live_objects()):
            pre = r[22:23]
            nx = variant.prim_q[i, 0:1]
            if spec.shape_type[i] == schema.SHAPE_SPHERE:
                assert torch.equal(pre, nx * nx)
            elif float(nx) != 0.0:
                t, _ = _object_t(variant, spec, i, ro, rd, a, 0.5 / a)
                assert (pre / nx).numpy().view(np.uint32) == t.numpy().view(
                    np.uint32)
                n_planes += 1
    assert n_planes >= sum(t == schema.SHAPE_PLANE for t in spec.shape_type)


# ---- a numpy model of csrc/render_common.cuh::closest_hit

def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def model_closest_hit(buf, n_light, ro, rd):
    """The kernels' closest hit over a packed small scene, in float32 and
    the plain version's roundings: one loop over the rows in scene order,
    each a sphere or a plane by its flag, with the constant of its test
    read from column 22, and a strict < on the running minimum.  Returns
    (t, hit, row of the winner: the first on a miss)."""
    rows = buf[24 + 16 * n_light:].reshape(-1, 24)
    a = _dot(rd, rd)
    inv2a = F32(0.5) / np.where(a > 0, a, F32(1))
    a4 = F32(4) * a
    t_best = np.full(len(ro), np.inf, F32)
    best = np.zeros(len(ro), np.int64)
    hit = np.zeros(len(ro), bool)
    with np.errstate(all="ignore"):
        for o, r in enumerate(rows):
            if r[21] > 0.5:
                oc = ro - r[0:3]
                b = F32(2) * _dot(rd, oc)
                cc = _dot(oc, oc) - r[22]
                disc = b * b - a4 * cc
                pos = disc > 0
                sq = np.sqrt(np.where(pos, disc, F32(1)))
                t1 = (-b - sq) * inv2a
                t = np.where(t1 > 0, t1, (-b + sq) * inv2a)
                valid = pos & (t > 0)
            else:
                denom = _dot(rd, r[3:6])
                numer = r[22] - _dot(ro, r[3:6])
                ok = denom != 0
                t = numer / np.where(ok, denom, F32(1))
                valid = ok & (t > 0)
            hit |= valid
            better = valid & (t < t_best)
            t_best, best = np.where(better, t, t_best), np.where(better, o, best)
    return t_best, hit, best


def _test_rays(name, n, seed):
    """Rays from inside and around the scene in random directions, and for
    the tie scene the rays that meet a sphere and a plane at the same t,
    and rays that graze the sphere at (0, 0, -4) and meet nothing else."""
    rs = np.random.RandomState(seed)
    ro = np.concatenate([rs.uniform([-3.4, 0.1, -3.9], [3.4, 6.9, 8.0],
                                    (n // 2, 3)),
                         rs.uniform([-30, -10, -30], [30, 30, 40],
                                    (n - n // 2, 3))]).astype(F32)
    rd = rs.normal(size=(n, 3)).astype(F32)
    if name == "ties":
        ro[:4] = 0.0
        rd[:4] = [[0, 0, -1], [0, 0, -2], [1, 0, 0], [2, 0, 0]]
        # tangents to the sphere from (3, 0, -4), in the plane z = -4: sin
        # = 1/3, a few ulps either side
        ang = np.arcsin(1 / 3) + np.arange(-8, 8) * 1e-7
        k = len(ang)
        ro[4:4 + k] = [3.0, 0.0, -4.0]
        rd[4:4 + k] = np.stack([-np.cos(ang), np.sin(ang), np.zeros(k)], 1)
    return ro, rd


@pytest.mark.parametrize("name", ["cornell", "showcase", "ties"])
def test_closest_hit_model_equals_plain(name):
    """Ids exactly and t to the bit, on every ray that hits; misses on the
    same rays, where the model's row is the first live object's."""
    sc = _scene(name)
    spec = sc.spec
    buf = megakernel.pack_scene(sc.data, spec).numpy()
    ro, rd = _test_rays(name, 4096, 11)
    t, hit, best = model_closest_hit(buf, spec.n_lights, ro, rd)
    ids = np.asarray(spec.live_objects())[best]
    want = closest_hit(sc.data, spec,
                       V3(*(torch.from_numpy(ro[:, i]) for i in range(3))),
                       V3(*(torch.from_numpy(rd[:, i]) for i in range(3))))
    w_hit = want.hit.numpy()
    assert np.array_equal(hit, w_hit) and 0.2 < hit.mean() <= 1.0
    assert np.array_equal(ids[hit], want.obj.numpy()[hit])
    assert (ids[~hit] == spec.live_objects()[0]).all()
    assert np.array_equal(t.view(np.uint32), want.t.numpy().view(np.uint32))
    if name == "ties":
        # the tie rays: the plane before the sphere wins at t = 3 and 1.5,
        # the sphere before the plane at t = 4 and 2 (the first in scene
        # order, as the plain version's strict < keeps it)
        assert ids[:4].tolist() == [0, 0, 5, 5]
        assert t[:4].tolist() == [3.0, 1.5, 4.0, 2.0]
        # the tangents: some hit the sphere, some pass it
        graze = ids[4:20] == 1
        assert graze.any() and not graze.all()


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_linear_kernel_tie_ids_on_card(cuda_device):
    """K1 on the tie scene at max_depth -1, where a lane's radiance is its
    winner's ambient color: the winners equal the plain version's on
    every lane, the planes' exact ties included."""
    sc = build_scene(dsl.parse(TIES), device=cuda_device)
    spec = dataclasses.replace(sc.spec, max_depth=-1)
    rs = np.random.RandomState(12)
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, 32, 16384), rs.randint(0, 32, 16384),
        rs.randint(0, 2, 16384), np.zeros(16384, np.int64))]
    before = megakernel.LAUNCHES[megakernel.KERNEL_LINEAR]
    got = megakernel.radiance_lanes(sc.data, spec, *lanes, 12)
    want = megakernel.radiance_lanes_reference(sc.data, spec, *lanes, 12)
    torch.cuda.synchronize()
    assert megakernel.LAUNCHES[megakernel.KERNEL_LINEAR] == before + 1
    assert torch.equal(ambient_ids(got.x), ambient_ids(want.x))
    assert (ambient_ids(got.x) >= 0).float().mean() > 0.5
