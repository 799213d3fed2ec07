"""The ring instances of the render kernels
(``raytrace_tpu_torch.render.ring_shade``, ``csrc/ring_shade.cu``) and the
ring's round loop (``raytrace_tpu_torch.parallel.ring.ring_radiance``).

On the CPU the round loop runs with the kernels' plain twin,
``ring_shade_reference``, as its step, on small scenes (70-100-object
sphere fields, 16x16 pixels, 2 spp) and is held:

* to the port's plain ring path (``radiance_lanes_reference`` under a ring
  context, what the CPU renders): fan-out scenes to the bit; linear scenes
  by the K1 rule (99% of lanes within ``1e-4 * max(1, |ref|)`` per channel,
  means within 1e-3; on the CPU they agree to the bit too);
* to the JAX package's ``render_image_ring`` on its CPU mesh, by the K1
  rule's per-lane test on every pixel where the port's dense render meets
  it (the rule's 99% share does not hold between the packages on this
  field: see that test);
* at k = 2 (a gloo group of two ranks) to k = 1, to the bit, on a lit
  fan-out scene whose ranks' lanes end at different rounds: both ranks
  take the same rounds.

``ring_start`` takes integer identities of either width as they come: on
the CPU its lane state from int64 ids, with or without bits above 2^32,
equals that from the int32 ids of the same low words, and
``ring_shade.start_ids`` hands the kernel int32 ids uncopied and any
other ids as int64.

The tests marked ``cuda`` hold the ring kernels, the rows' gather among
them, to the twin on the card, ``ring_rows`` and ``ring_start`` also alone
(to the bit, one launch each), skipped where torch sees no GPU."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.parallel import ring as jax_ring
from raytrace_tpu.parallel.mesh import make_mesh as jax_mesh
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.ops import _build, intersect
from raytrace_tpu_torch.parallel import ring
from raytrace_tpu_torch.parallel.mesh import Mesh, make_mesh
from raytrace_tpu_torch.render import megakernel, ring_shade
from raytrace_tpu_torch.render.integrator import lane_ids, render_image
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.scene.procedural import (make_sphere_field,
                                                 sphere_field_source)
from raytrace_tpu_torch.scene.schema import BG_SKYBOX

import test_torch_group as group
from test_torch_megakernel import LANE_RTOL, assert_radiance_close

SEED = 5
W = H = 16
SPP = 2

# a Phong mirror floor and a Phong sphere under a point and a directional
# light, through a depth-of-field camera: one child slot, lit
LIT_MIRROR = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8
        ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: PhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0.4,0.4,0.4) exponent: 16 ambient: rgb(0,0,0) } }
  ]
  lights: [
    { model: PointLight { location: (2, 3, -1) } color: rgb(1.2,1.1,1.0) }
    { model: DirectionalLight { direction: (0, -1, -0.2) }
      color: rgb(0.3, 0.3, 0.35) }
  ]
  camera: DepthOfFieldCamera new(
    new((0,0,0), (0,0,-1), (0,1,0), 2),
    4.0, 0.05, 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 16 height: 16 antialias: 2 }
}"""
# the field's walls that keep rays from the sky: all but the floor and the
# back wall
OPEN_FIELD = ("(0, 30, 0)", "(-30, 0, 0)", "(30, 0, 0)")
POINT_LIGHT = """lights: [
        { model: PointLight { location: (0, 20, 10) }
          color: rgb(30, 28, 26) } ]"""


def field(n, mix, device="cpu", **spec):
    sc = make_sphere_field(n, width=W, height=H, antialias=SPP,
                           mix_materials=mix, device=device)
    return dataclasses.replace(sc, spec=dataclasses.replace(sc.spec, **spec))


def open_sky_field(n, device="cpu"):
    """The linear field without its side walls and ceiling, under a
    random 4x4 sky cube."""
    text = sphere_field_source(n, width=W, height=H, antialias=SPP,
                               mix_materials=False)
    for point in OPEN_FIELD:
        text, k = re.subn(r"\{\s*bounds: Plane \{ point: " + re.escape(point)
                          + r"[^}]*\}\s*material: \w+ \{[^}]*\}\s*\}", "",
                          text)
        assert k == 1
    sc = build_scene(dsl.parse(text), device=device)
    cube = torch.rand((6, 4, 4, 3), generator=torch.Generator().manual_seed(0))
    return dataclasses.replace(
        sc, spec=dataclasses.replace(sc.spec, bg_type=BG_SKYBOX,
                                     face_sizes=((4, 4),) * 6),
        data=dataclasses.replace(sc.data, bg_cube=cube.to(device)))


def scene(case, device="cpu"):
    if case == "linear field":
        return field(80, False, device)
    if case == "mixed field":
        return field(80, True, device)
    if case == "lit mixed field":
        sc = build_scene(dsl.parse(sphere_field_source(
            70, width=W, height=H, antialias=SPP, mix_materials=True)
            .replace("lights: [ ]", POINT_LIGHT)), device=device)
        return dataclasses.replace(sc, spec=dataclasses.replace(sc.spec,
                                                                max_depth=2))
    if case == "lit mirror":
        return build_scene(dsl.parse(LIT_MIRROR), device=device)
    if case == "field under the sky":
        return open_sky_field(80, device)
    raise ValueError(case)


def pixel_lanes(spec, device="cpu"):
    """Every lane of the image: W x H pixels x SPP samples."""
    pix = torch.arange(spec.width * spec.height, device=device)
    return lane_ids(pix % spec.width, pix // spec.width,
                    torch.arange(SPP, device=device), spec.cam_samples)


def round_loop(sc, lanes, step=ring_shade.ring_shade_reference, mesh=None):
    """The round loop on ``lanes`` under a ring context of ``mesh``."""
    mesh = mesh or Mesh(sc.data.device)
    with ring.ring_context(sc.data, sc.spec, mesh) as stripped:
        return torch.stack(list(ring.ring_radiance(
            intersect.ring_ctx(), stripped, sc.spec, *lanes, SEED,
            step=step)))


def plain_ring(sc, lanes):
    """The port's plain ring path on ``lanes``."""
    with ring.ring_context(sc.data, sc.spec, Mesh(sc.data.device)) as st:
        return torch.stack(list(megakernel.radiance_lanes_reference(
            st, sc.spec, *lanes, SEED)))


CASES = ["linear field", "mixed field", "lit mirror", "field under the sky",
         "lit mixed field"]


@pytest.mark.parametrize("case", CASES)
def test_round_loop_matches_plain_ring(case):
    """The round loop with the plain twin against the plain ring path on every
    lane of the image: fan-out scenes to the bit, linear ones by the K1
    rule."""
    sc = scene(case)
    lanes = pixel_lanes(sc.spec)
    got, want = round_loop(sc, lanes), plain_ring(sc, lanes)
    assert torch.isfinite(got).all() and want.std() > 0
    if sc.spec.children_per_ray > 1:
        assert torch.equal(got, want)
    else:
        assert_radiance_close(got.double().numpy(), want.double().numpy())


def test_sky_field_takes_the_sky():
    """The open field's misses take the sky: its image is not the one
    under the solid background."""
    sky = scene("field under the sky")
    solid = dataclasses.replace(sky, spec=dataclasses.replace(
        sky.spec, bg_type=field(80, False).spec.bg_type))
    lanes = pixel_lanes(sky.spec)
    assert not torch.equal(round_loop(sky, lanes), round_loop(solid, lanes))


def test_round_loop_matches_jax_ring():
    """The round loop's image (the plain twin; the per-pixel mean of the
    lanes, as ``sample_pixels`` takes it) against the JAX package's
    ``render_image_ring`` on its CPU mesh (tests/test_ring.py's scene at
    16x16, 2 spp), by the K1 rule's per-lane test, ``|d| <= 1e-4 * max(1,
    |ref|)`` per channel.  The rule's share (99%) and its means (1e-3) do
    not hold between the two packages on this field: the port's dense
    render, the path every accepted port test holds to JAX, parts from
    JAX's on 5 of the 256 pixels, by up to 0.45 relative on the bright
    dome, and their means by 4%.  Anchored at float64
    (tests/test_torch_field_f64.py), where the packages agree to 7.4e-13,
    the port's float32 render parts from float64 on 3 pixels and JAX's on
    7; the parted lanes fork at a near-tie: pixel (x 11, y 1)'s secondary
    ray leaves the emissive dome from an origin 1.6 float32 steps outside
    its surface in the port and 0.75 inside it in JAX's compiled program,
    whose ray then hits the dome again at t = 2.6e-4.  So the round loop's
    image must equal the port's dense image to the bit, and part from
    JAX's only on pixels where that one does (at most 2.5% of them)."""
    ts = make_sphere_field(100, width=W, height=H, antialias=1,
                           mix_materials=False, device="cpu")
    js = jax_field(100, width=W, height=H, antialias=1, mix_materials=False,
                   dtype=jnp.float32)
    rad = round_loop(ts, pixel_lanes(ts.spec))
    got = rad.reshape(3, W * H, SPP).mean(dim=2).T.reshape(H, W, 3).double()
    want = np.asarray(jax_ring.render_image_ring(js, seed=SEED, spp=SPP,
                                                 mesh=jax_mesh()))
    dense = render_image(ts, seed=SEED, spp=SPP)
    np.testing.assert_array_equal(got.numpy(), dense)

    def parted(img):
        d = np.abs(img - want) > LANE_RTOL * np.maximum(1.0, np.abs(want))
        return d.any(axis=2)

    off = parted(got.numpy())
    assert not (off & ~parted(dense)).any()
    assert off.mean() <= 0.025, off.sum()


def test_two_ranks_leave_the_round_loop_together(tmp_path):
    """A lit fan-out scene at k = 2 over gloo, rank 0 holding the lanes of
    fewest nodes and rank 1 those of most: both ranks take the rounds of
    the longest lane (rank 0 goes on with no live lane, so that the ring's
    hand-offs pair up), and every lane equals k = 1 to the bit."""
    sc = scene("lit mixed field")
    lanes = pixel_lanes(sc.spec)
    one, live = group.ring_radiance_job(sc, [lanes], SEED)
    # each lane's nodes: the rounds at which it was live
    nodes = torch.zeros(lanes[0].shape[0], dtype=torch.int64)
    ref = ring_shade.ring_shade_reference

    def finish(data, spec, state, *answers):
        nodes.add_(state.live.to(torch.int64))
        ref.finish(data, spec, state, *answers)

    again = round_loop(sc, lanes, ref._replace(finish=finish))
    assert torch.equal(again, one) and len(live) == int(nodes.max())
    order = torch.argsort(nodes, stable=True)
    short, long_ = order[:64], order[-64:]
    assert nodes[short].max() < nodes[long_].max()
    parts = [[t[idx] for t in lanes] for idx in (short, long_)]
    outs = group.run_group(group.ring_radiance_job, 2, sc, parts, SEED,
                           out_dir=tmp_path)
    (acc0, live0), (acc1, live1) = outs
    assert len(live0) == len(live1) == int(nodes[long_].max())
    assert live0[-1] == 0 and live1[-1] > 0
    assert torch.equal(acc0, one[:, short]) and torch.equal(acc1,
                                                            one[:, long_])


@pytest.mark.parametrize("case", ["mixed field", "lit mixed field"])
def test_rounds_are_the_longest_lanes_nodes(case):
    """A fan-out scene's round loop takes as many rounds as the longest
    lane has live nodes, counted on the plain walk by
    ``work.path_work``: what chip_smoke.py expects of the scan kernel's
    launches in a ring render."""
    from raytrace_tpu_torch.render import work

    sc = scene(case)
    lanes = pixel_lanes(sc.spec)
    rounds = []
    ref = ring_shade.ring_shade_reference

    def finish(data, spec, state, *answers):
        rounds.append(int(state.live.sum()))
        ref.finish(data, spec, state, *answers)

    round_loop(sc, lanes, ref._replace(finish=finish))
    most = work.path_work(sc.data, sc.spec, lanes, SEED)["most"]
    assert len(rounds) == most > sc.spec.max_depth + 1
    assert rounds[-1] > 0


def test_wrappers_on_cpu_run_the_twin():
    """On CPU tensors the three wrappers are the plain twin and launch
    nothing, and the round loop's default step is the wrappers."""
    sc = scene("lit mixed field")
    lanes = pixel_lanes(sc.spec)
    before = dict(_build.LAUNCHES)
    got = round_loop(sc, lanes, step=ring_shade.ring_shade_kernels)
    assert torch.equal(got, round_loop(sc, lanes))
    with ring.ring_context(sc.data, sc.spec, Mesh(torch.device("cpu"))) as st:
        assert torch.equal(torch.stack(list(ring.ring_radiance(
            intersect.ring_ctx(), st, sc.spec, *lanes, SEED))), got)
    assert _build.LAUNCHES == before


@pytest.mark.parametrize("case", ["linear field", "mixed field"])
def test_lane_state_at_the_end(case):
    """After the last round every lane's walk has ended: no live lane, a
    zero direction in every node, every DFS stack empty; the state's
    shapes are the kernels' (13 node words, cap * 13 stack words)."""
    sc = scene(case)
    lanes = pixel_lanes(sc.spec)
    n = lanes[0].shape[0]
    seen = []
    ref = ring_shade.ring_shade_reference

    def finish(data, spec, state, *answers):
        ref.finish(data, spec, state, *answers)
        seen.append(state)

    round_loop(sc, lanes, ref._replace(finish=finish))
    state = seen[-1]
    assert state.node.shape == (13, n) and state.acc.shape == (3, n)
    assert state.stack.shape == (ring_shade.stack_entries(sc.spec) * 13, n)
    assert not state.live.any() and not state.sp.any()
    assert not state.node[3:6].any()
    if sc.spec.children_per_ray <= 1:
        assert len(seen) == sc.spec.max_depth + 2


def test_shadow_queries():
    """The twin's shadow pass writes a query for each light of a live
    node that a gate leaves open, and zeros elsewhere: on dead lanes and
    on misses.  A directional light's squared range is 0."""
    sc = scene("lit mirror")
    lanes = pixel_lanes(sc.spec)
    ref = ring_shade.ring_shade_reference
    with ring.ring_context(sc.data, sc.spec, Mesh(torch.device("cpu"))) as st:
        ctx = intersect.ring_ctx()
        state = ref.start(st, sc.spec, *lanes, SEED)
        state.live[::2] = 0
        ro, rd = state.rays()
        t, obj, hit = ring.ring_closest_hit_local(ctx.shard, ctx.n_sph_pad,
                                                  ro, rd, ctx.mesh)
        rows = ring.ring_gather_rows(ctx.mat_rows, obj, ctx.mesh)
        q = ref.shadow(st, sc.spec, state, t, hit, rows)
    assert q.shape == (2, 7, lanes[0].shape[0])
    asked = q.abs().sum(dim=1) > 0
    assert not asked[:, ::2].any() and not asked[:, ~hit].any()
    assert asked[:, 1::2].sum() > 0 and not q[1, 6].any()
    assert (q[0, 6][asked[0]] > 0).all()


def test_max_lanes_bounds_the_stacks():
    """A launch's DFS stacks stay within their budget; a linear scene's
    launches keep the caller's."""
    lin, mixed = field(80, False), field(80, True)
    assert ring_shade.max_lanes(lin.spec, 1 << 22) == 1 << 22
    assert ring_shade.stack_entries(lin.spec) == 0
    deep = dataclasses.replace(mixed.spec, max_depth=0)
    cap = ring_shade.stack_entries(mixed.spec)
    assert cap == 6 and ring_shade.tree_m(mixed.spec) == 2
    budget = megakernel.TREE_SLAB_MAX_BYTES // (52 * cap)
    assert ring_shade.max_lanes(mixed.spec, 1 << 30) == budget
    assert ring_shade.max_lanes(deep, 1 << 20) == 1 << 20


def test_header_buffer_reads_no_object_leaf():
    """The ring kernels' scene buffer is the header and the lights of the
    kernels' scene buffer, and packs from the ring's stripped scene; the
    rows come round the ring in the kernels' row layout."""
    sc = scene("lit mirror")
    full = megakernel.pack_scene(sc.data, sc.spec)
    head = megakernel.pack_header(ring.strip_object_data(sc.data), sc.spec)
    assert head.shape == (24 + 16 * sc.spec.n_lights,)
    assert torch.equal(full[:head.shape[0]], head)
    rows = megakernel.kernel_rows(intersect.object_table(sc.data, sc.spec))
    assert rows.shape == (2, 24) and not rows[:, 22:].any()
    with ring.ring_context(sc.data, sc.spec, make_mesh("cpu")):
        assert torch.equal(intersect.ring_ctx().mat_rows[:2], rows)


def _id_forms(lanes, form):
    """``lanes`` (int64 identity tensors) as the ``form`` asks: int32, or
    int64 with the same low 32 bits and, for "int64 above 2^32", other
    bits above them."""
    if form == "int32":
        return [t.to(torch.int32) for t in lanes]
    if form == "int64 above 2^32":
        return [t + ((torch.arange(t.shape[0]) % 5 + 1) << 32).to(t.device)
                for t in lanes]
    return [t.to(torch.int64) for t in lanes]


def _states_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("form", ["int64", "int64 above 2^32"])
@pytest.mark.parametrize("case", ["linear field", "lit mirror"])
def test_start_reads_ids_of_either_width(case, form):
    """``ring_start``'s lane state (node, sum, flag, stack pointer, stack)
    from int64 ids equals that from the int32 ids of the same low 32 bits,
    with the pinhole camera and the depth-of-field camera; the kernel
    keeps each id's low word as the plain version does."""
    sc = scene(case)
    lanes = pixel_lanes(sc.spec)
    want = ring_shade.ring_start(sc.data, sc.spec,
                                 *_id_forms(lanes, "int32"), SEED)
    got = ring_shade.ring_start(sc.data, sc.spec, *_id_forms(lanes, form),
                                SEED)
    assert want.live.all() and want.node[3:6].any()
    assert _states_equal(got, want)


@pytest.mark.parametrize("forms,width,copied", [
    (("int32",) * 4, 4, False),
    (("int64",) * 4, 8, False),
    (("int32", "int64", "int32", "int64"), 8, True),
    (("int16",) * 4, 8, True),
    (("int32 strided",) * 4, 4, True)])
def test_start_ids(forms, width, copied):
    """What ``ring_start`` hands its kernel: four int32 or four int64
    contiguous tensors as they come, uncopied; ids of mixed widths, or of
    another width, as int64; a strided tensor made contiguous."""
    base = torch.arange(10, dtype=torch.int64) * 7 + 3

    def make(form):
        if form == "int32 strided":
            return base.repeat_interleave(2).to(torch.int32)[::2]
        return base.to(getattr(torch, form))

    ids = [make(f) for f in forms]
    words, got_width = ring_shade.start_ids(*ids)
    assert got_width == width
    assert all(w.is_contiguous() and w.element_size() == width
               and torch.equal(w.to(torch.int64), base) for w in words)
    assert any(w.data_ptr() != t.data_ptr()
               for w, t in zip(words, ids)) == copied


def test_radiance_lanes_ring_needs_a_context():
    sc = scene("linear field")
    lanes = pixel_lanes(sc.spec)
    with pytest.raises(ValueError, match="ring context"):
        megakernel.radiance_lanes_ring(sc.data, sc.spec, *lanes, SEED)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_ring_instances_match_twin_on_card(case, cuda_device, monkeypatch):
    """On the card a ring render's lanes go through the ring kernels and
    never through ``radiance_lanes_reference`` (made to raise on CUDA
    tensors here): against the plain twin on the same lanes, fan-out
    scenes to the bit, linear ones by the K1 rule."""
    real = megakernel.radiance_lanes_reference

    def refuse(data, *args):
        if data.device.type == "cuda":
            raise AssertionError("the plain version ran on the card")
        return real(data, *args)

    monkeypatch.setattr(megakernel, "radiance_lanes_reference", refuse)
    sc = scene(case, cuda_device)
    lanes = pixel_lanes(sc.spec, cuda_device)
    before = dict(_build.LAUNCHES)
    with ring.ring_context(sc.data, sc.spec, Mesh(cuda_device)) as st:
        got = torch.stack(list(megakernel.radiance_lanes(st, sc.spec, *lanes,
                                                         SEED)))
    torch.cuda.synchronize()
    rose = {k: _build.LAUNCHES[k] - before[k] for k in _build.LAUNCHES}
    assert all(rose[k] > 0 for k in ("ring_start", "ring_rows",
                                     "ring_finish"))
    assert (rose["ring_shadow"] > 0) == bool(sc.spec.n_lights)
    assert rose[_build.KERNEL_RING] == sum(rose[k]
                                           for k in _build.RING_KERNELS)
    # the twin gathers its rows by the plain selects: every ring kernel
    # is held to its plain version
    want = round_loop(sc, lanes)
    if sc.spec.children_per_ray > 1:
        assert torch.equal(got, want)
    else:
        assert_radiance_close(got.double().cpu().numpy(),
                              want.double().cpu().numpy())


def _device_kernels(fn):
    """The names of the device kernels that ``fn`` launches, from
    torch.profiler.  The recording starts with 64 trivial additions, which
    a recording late in a process may lose in place of ``fn``'s; they are
    left out by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            scratch.add_(1.0)
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False)
             and e.name not in _build.KERNELS]
    pads = [x for x in names if "add" in x.lower()]
    assert len(pads) <= 64
    return [x for x in names if "add" not in x.lower()]


@pytest.mark.cuda
@pytest.mark.parametrize("first_at", ["0", "per"])
@pytest.mark.parametrize("per", [1, 37, 1006])
@pytest.mark.parametrize("n", [1, 31, 33, 4099, 65541])
def test_rows_kernel_matches_plain_on_card(cuda_device, n, per, first_at):
    """One step of the rows' ring (``ring_rows``) on a shard that holds
    object ids [first, first + per), first 0 or ``per``: the lanes whose
    winner it holds take that row, the others keep theirs, to the bit,
    whatever the lanes' count against the warp (1, 31, 33 and more) and
    the shard's size; one launch, counted."""
    g = torch.Generator().manual_seed(SEED + n + per)
    first = 0 if first_at == "0" else per
    shard = torch.rand((per, 24), generator=g).to(cuda_device)
    obj = torch.randint(0, 3 * per, (n,), generator=g,
                        dtype=torch.int32).to(cuda_device)
    out = torch.rand((n, 24), generator=g).to(cuda_device)
    local = obj.long() - first
    mine = (local >= 0) & (local < per)
    want = torch.where(mine[:, None], shard[local.clamp(0, per - 1)], out)
    before = _build.LAUNCHES["ring_rows"]
    ring_shade.gather_rows(shard, first, obj, out)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ring_rows"] == before + 1
    assert torch.equal(out, want)
    if n > 1:
        assert 0 < int(mine.sum()) < n


@pytest.mark.cuda
def test_gather_rows_at_one_rank_launches_one_kernel(cuda_device):
    """At k = 1 without grad, ``ring_gather_rows`` of the int32 winners
    launches ``ring_rows`` and no other device kernel, and equals its
    plain version to the bit."""
    sc = scene("linear field", cuda_device)
    mesh = Mesh(cuda_device)
    g = torch.Generator().manual_seed(SEED)
    with ring.ring_context(sc.data, sc.spec, mesh):
        ctx = intersect.ring_ctx()
        obj = torch.randint(0, 80, (4099,), generator=g,
                            dtype=torch.int32).to(cuda_device)
        got = ring.ring_gather_rows(ctx.mat_rows, obj, mesh)
        names = _device_kernels(
            lambda: ring.ring_gather_rows(ctx.mat_rows, obj, mesh))
        want = ring.ring_gather_rows_reference(ctx.mat_rows, obj, mesh)
    assert len(names) == 1 and "ring_rows_kernel" in names[0], names
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["int32", "int64"])
@pytest.mark.parametrize("case", ["linear field", "lit mirror"])
def test_start_kernel_matches_twin_on_card(cuda_device, case, form):
    """``ring_start`` on the card against ``start_reference`` on the same
    ids, int32 and int64, with the pinhole and the depth-of-field camera:
    the lane state equal to the bit; under torch.profiler the wrapper
    launches one device kernel, the kernel itself."""
    sc = scene(case, cuda_device)
    lanes = _id_forms(pixel_lanes(sc.spec, cuda_device), form)
    want = ring_shade.start_reference(sc.data, sc.spec, *lanes, SEED)
    before = _build.LAUNCHES["ring_start"]
    got = ring_shade.ring_start(sc.data, sc.spec, *lanes, SEED)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ring_start"] == before + 1
    assert _states_equal(got[:4], want[:4])
    names = _device_kernels(
        lambda: ring_shade.ring_start(sc.data, sc.spec, *lanes, SEED))
    assert len(names) == 1 and "ring_start_kernel" in names[0], names
