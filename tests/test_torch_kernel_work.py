"""What the redesigned tree kernel and table fold of the PyTorch port rest
on, checked on the CPU: the kernel-side table layout against the tables of
both packages, the plain scan against the JAX package's on tied spheres and
pad rows, the choice of the tree kernel's stack instance, the work counters
against brute-force counts, and that a live-only preorder walk sums to the
bits of the full walk.  The kernels themselves against their plain
versions: the ``cuda``-marked tests."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import intersect_pallas as jip
from raytrace_tpu.ops.intersect import _packed_tables as jax_packed_tables
from raytrace_tpu.scene.procedural import make_sphere_field as jax_field
from raytrace_tpu_torch.ops import _build, intersect, intersect_scan
from raytrace_tpu_torch.ops.intersect import scene_tables
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import integrator, megakernel, work
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene, load_scene_file
from raytrace_tpu_torch.scene.procedural import make_sphere_field
from raytrace_tpu_torch.scene.schema import BG_SKYBOX

from conftest import repo_path
from test_torch_scan import _incoherent_rays, _v3, interpret_env  # noqa: F401

SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
F32 = np.float32
INF = F32(np.inf)

# a Phong floor under a sphere that takes `samples` indirect samples
INDIRECT = """{
  objects: [
    { bounds: Plane { point: (0, -1, 0) normal: (0, 1, 0) }
      material: PhongMaterial { diffuse: rgb(0.6,0.5,0.4)
        specular: rgb(0.3,0.3,0.3) exponent: 8
        ambient: rgb(0.05,0.05,0.05) } }
    { bounds: Sphere { center: (0, 0, -4) radius: 1 }
      material: IndirectPhongMaterial { diffuse: rgb(0.8,0.3,0.2)
        specular: rgb(0,0,0) exponent: 1 ambient: rgb(0.2,0.2,0.2)
        samples: SAMPLES } }
  ]
  lights: [
    { model: PointLight { location: (2, 3, -1) } color: rgb(1.2,1.1,1.0) }
  ]
  camera: SimplePerspectiveCamera new((0,0,0), (0,0,-1), (0,1,0), 2)
  background: SolidColorBackground { color: rgb(0.1, 0.12, 0.15) }
  options: { width: 32 height: 32 antialias: 2 }
}"""


def _indirect_scene(samples, max_depth, device="cpu"):
    sc = build_scene(dsl.parse(INDIRECT.replace("SAMPLES", str(samples))),
                     device=device)
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, max_depth=max_depth))


def _fold_parts(tb):
    """The three parts of a scene's fold buffer, as numpy arrays."""
    buf = intersect_scan.fold_buffer(tb.table, tb.ids, tb.n_sph_pad,
                                     tb.bounds).numpy()
    n_rows = tb.table.shape[0]
    rows = buf[:n_rows * 4].view(F32).reshape(n_rows, 4)
    ids = buf[n_rows * 4:n_rows * 5]
    bounds = buf[n_rows * 5:].view(F32).reshape(-1, 4)
    return buf, rows, ids, bounds


# ---- (a) the kernel-side table layout


@pytest.mark.parametrize("mix", [False, True])
def test_fold_buffer_layout(mix):
    """Rows, ids and bounds lie behind one another as the kernels read
    them; a sphere row carries float32(r) * float32(r), the bits the plain
    scan squares, and -inf on pad rows; plane rows, ids and bounds are the
    tables' own; the centers are the JAX package's table's, in the rows
    that the ids name."""
    ts = make_sphere_field(100, mix_materials=mix, device="cpu")
    tb = scene_tables(ts.data, ts.spec)
    buf, rows, ids, bounds = _fold_parts(tb)
    n_rows, n_chunks = tb.table.shape[0], tb.table.shape[0] // 32
    assert buf.dtype == np.int32 and buf.shape == (n_rows * 5 + n_chunks * 4,)
    assert buf.nbytes == intersect_scan.fold_bytes(n_chunks)
    assert intersect_scan.fold_bytes(n_chunks) == n_chunks * (
        32 * intersect_scan.FOLD_ROW_BYTES + intersect_scan.FOLD_CHUNK_BYTES)
    table = tb.table.numpy()
    n_sph = tb.n_sph_pad
    np.testing.assert_array_equal(rows[:, :3], table[:, :3])
    np.testing.assert_array_equal(rows[n_sph:], table[n_sph:])
    np.testing.assert_array_equal(ids, tb.ids.numpy())
    np.testing.assert_array_equal(bounds, tb.bounds.numpy())
    real = tb.ids.numpy()[:n_sph] >= 0
    r = table[:n_sph, 3]
    assert real.sum() == 101 and (r[real] > 0).all()
    # bit for bit the product the plain scan forms per ray (c3 * c3)
    np.testing.assert_array_equal(rows[:n_sph, 3][real].view(np.int32),
                                  (r[real] * r[real]).view(np.int32))
    np.testing.assert_array_equal(
        rows[:n_sph, 3][real],
        (tb.table[:n_sph, 3] * tb.table[:n_sph, 3]).numpy()[real])
    assert np.isneginf(rows[:n_sph, 3][~real]).all() and (~real).sum() == 27
    want_table, want_pad, want_ids = jax_packed_tables(
        *(lambda s: (s.data, s.spec))(jax_field(100, mix_materials=mix)))
    assert want_pad == n_sph
    want_table, want_ids = np.asarray(want_table), np.asarray(want_ids)
    row_of = {g: k for k, g in enumerate(want_ids) if g >= 0}
    got_ids = tb.ids.numpy()
    src = [row_of[g] for g in got_ids[got_ids >= 0]]
    np.testing.assert_array_equal(rows[got_ids >= 0, :3], want_table[src, :3])
    np.testing.assert_array_equal(rows[got_ids < 0, :3],
                                  want_table[want_ids < 0, :3])


def test_fold_buffer_masks_what_the_plain_scan_rejects():
    """A sphere whose radius is zero, negative or NaN is never hit in the
    plain scan (c3 > 0 fails); its row carries -inf like a pad row's, which
    keeps the kernels' discriminant from ever being positive."""
    ts = make_sphere_field(40, device="cpu")
    tb = scene_tables(ts.data, ts.spec)
    table = tb.table.clone()
    table[3, 3], table[4, 3], table[5, 3] = 0.0, -1.0, float("nan")
    rows = _fold_parts(tb._replace(table=table))[1]
    assert np.isneginf(rows[3:6, 3]).all() and np.isfinite(rows[:3, 3]).all()
    ro, rd = _incoherent_rays(256, 2)
    _, gid, hit = intersect_scan.scan_hit_reference(
        table, tb.ids, tb.n_sph_pad, _v3(ro, torch), _v3(rd, torch))
    assert hit.any() and not np.isin(gid.numpy(), tb.ids[3:6].numpy()).any()
    for o, d in zip(ro[:64], rd[:64]):
        valid, _ = _sphere_row_t(rows[:tb.n_sph_pad], _make_ray(o, d))
        assert not valid[3:6].any() and not valid[tb.ids.numpy()[
            :tb.n_sph_pad] < 0].any()


def test_fold_gives_way_to_device_memory_by_size(monkeypatch):
    """The table is staged in shared memory up to the limit derived from
    the card (here an H100's, with the scan kernel at 48 registers) with
    whatever else the block keeps there, and read from device memory
    above that."""
    from test_torch_gpu_info import H100

    from raytrace_tpu_torch.utils import gpu_info

    monkeypatch.setattr(intersect_scan, "FOLD_SHARED_MAX_BYTES",
                        gpu_info.fold_shared_max_bytes(gpu_info.card(H100),
                                                       48))
    per_chunk = intersect_scan.fold_bytes(1)
    assert per_chunk == 32 * 20 + 16
    limit = intersect_scan.fold_shared_max_bytes()
    assert limit == 44 * 1024
    last = limit // per_chunk
    assert intersect_scan.fold_in_shared(last)
    assert not intersect_scan.fold_in_shared(last + 1)
    assert not intersect_scan.fold_in_shared(last, other_bytes=per_chunk)
    # 1,006 objects (33 chunks) are staged beside the scene's header and
    # lights; 4,006 objects (127 chunks) are not
    assert intersect_scan.fold_in_shared(33, other_bytes=96)
    assert not intersect_scan.fold_in_shared(127)
    # five blocks of the limit, with the 1 KB an SM reserves for each, fit it
    assert 5 * (limit + 1024) <= 228 * 1024


# ---- the kernels' sphere-row and chunk-bound tests in numpy, float32
# throughout: what the brute-force count of entered chunks needs


def _dot(ax, ay, az, bx, by, bz):
    return (ax * bx + ay * by) + az * bz


def _make_ray(o, d):
    o, d = [F32(c) for c in o], [F32(c) for c in d]
    a = _dot(d[0], d[1], d[2], d[0], d[1], d[2])
    return (*o, *d, a, F32(0.5) / (a if a > 0 else F32(1)), F32(4) * a)


def _sphere_row_t(r, q):
    """(valid, t) of the fold buffer's sphere rows r (.., 4) for one ray."""
    ox, oy, oz, dx, dy, dz, _, inv2a, a4 = q
    ocx, ocy, ocz = ox - r[..., 0], oy - r[..., 1], oz - r[..., 2]
    with np.errstate(invalid="ignore", over="ignore"):
        b = F32(2) * _dot(dx, dy, dz, ocx, ocy, ocz)
        cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - r[..., 3]
        disc = b * b - a4 * cc
        has = disc > 0
        sq = np.sqrt(np.where(has, disc, F32(1)))
        t1 = (-b - sq) * inv2a
        t = np.where(t1 > 0, t1, (-b + sq) * inv2a)
    return has & (t > 0), t


def _chunk_bound(bs, q):
    """(may, t_enter, margin) of one chunk's bounding sphere for one ray."""
    ox, oy, oz, dx, dy, dz, a, inv2a, _ = q
    ocx, ocy, ocz = ox - bs[0], oy - bs[1], oz - bs[2]
    with np.errstate(invalid="ignore", over="ignore"):
        b = F32(2) * (dx * ocx + dy * ocy + dz * ocz)
        cc = (ocx * ocx + ocy * ocy + ocz * ocz) - bs[3] * bs[3]
        disc = b * b - F32(4) * a * cc
        pos = disc > F32(-1e-5) * (b * b)
        sq = np.sqrt(np.maximum(disc, F32(0)))
        margin = F32(1e-5) * np.abs(b) * inv2a + F32(1e-4)
        return (pos and (-b + sq) * inv2a > -margin, (-b - sq) * inv2a,
                margin)


def _chunks_entered(rows, bounds, n_sph_chunks, q):
    """The sphere chunks one ray enters, in table order against its running
    best t, as a thread of the kernels walks them."""
    t_best, entered = INF, []
    for c in range(n_sph_chunks):
        may, t_enter, margin = _chunk_bound(bounds[c], q)
        if not (may and t_enter <= t_best + margin):
            continue
        entered.append(c)
        valid, t = _sphere_row_t(rows[c * 32:(c + 1) * 32], q)
        t_best = min([t_best, *t[valid]])
    return entered


def _tie_table():
    """Two chunks of unit spheres, every center present twice with the
    copies in different chunks and ids in falling order, and one plane."""
    rs = np.random.RandomState(7)
    centers = rs.uniform(-6, 6, (24, 3)).astype(F32)
    sph = np.zeros((64, 4), F32)
    ids = np.full(96, -1, np.int32)
    sph[:24, :3], sph[32:56, :3] = centers, centers[::-1]
    sph[:24, 3] = sph[32:56, 3] = 1.0
    ids[:24] = np.arange(100, 76, -1)
    ids[32:56] = np.arange(24)
    pln = np.zeros((32, 4), F32)
    pln[0] = (0, 1, 0, -8)
    ids[64] = 50
    table = torch.from_numpy(np.concatenate([sph, pln]))
    bounds = intersect_scan._chunk_bounds(table, 64, 3)
    return scene_tables(*(lambda s: (s.data, s.spec))(make_sphere_field(
        40, device="cpu")))._replace(table=table, ids=torch.from_numpy(ids),
                                     n_sph_pad=64, bounds=bounds)


def _aimed_rays(tb, n, seed):
    """Rays from all around aimed at the tie table's centers, so that most
    hit a tied pair."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-10, 10, (n, 3)).astype(F32)
    return ro, (tb.table[:24, :3].numpy()[rs.randint(0, 24, n)]
                - ro).astype(F32)


@pytest.mark.parametrize("rays", ["aimed", "incoherent"])
@pytest.mark.parametrize("table", ["ties", "pads"])
def test_ties_and_pad_rows_match_jax(table, rays, interpret_env):
    """The plain scan, with and without culling, against the JAX package's
    Pallas scan kernel (interpret mode) and its lax.scan reference, on the
    tables the card tests feed the CUDA kernel: every sphere tied with a
    copy in another chunk under a higher id (the lower id wins whatever row
    is tested first), and a 70-object field with pad rows in both
    partitions; on rays aimed at the spheres and on incoherent rays with
    dead lanes.  Ids and hits exact, t within 1e-4 relative."""
    if table == "ties":
        tb = _tie_table()
    else:
        ts = make_sphere_field(64, mix_materials=False, device="cpu")
        tb = scene_tables(ts.data, ts.spec)
        assert (tb.ids[:tb.n_sph_pad] < 0).sum() == 31
    ro, rd = (_aimed_rays(tb, 96, 8) if rays == "aimed"
              else _incoherent_rays(96, 5))
    args = (tb.table, tb.ids, tb.n_sph_pad, _v3(ro, torch), _v3(rd, torch))
    t, gid, hit = intersect_scan.scan_hit_reference(*args)
    for a, b in zip((t, gid, hit),
                    intersect_scan.scan_hit_reference(*args, tb.bounds)):
        assert torch.equal(a, b)
    jt, jids = jnp.asarray(tb.table.numpy()), jnp.asarray(tb.ids.numpy())
    for fn in (jip.scan_hit, jip._jnp_scan_reference):
        wt, wg, wh = fn(jt, jids, tb.n_sph_pad, _v3(ro, jnp), _v3(rd, jnp))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(wh))
        np.testing.assert_array_equal(gid.numpy(), np.asarray(wg))
        ok = hit.numpy()
        np.testing.assert_allclose(t.numpy()[ok], np.asarray(wt)[ok],
                                   rtol=1e-4)
    assert hit.numpy().mean() > (0.8 if (table, rays) == ("ties", "aimed")
                                 else 0.05)
    if (table, rays) == ("ties", "aimed"):
        assert (gid.numpy()[hit.numpy()] < 50).mean() > 0.8  # the lower ids


# ---- (b) the tree kernel's stack instance


@pytest.mark.parametrize("cap", [1, 2, 6, 8, 9, 16, 17, 22, 32, 33, 47, 64])
def test_tree_instance(cap):
    """The instance is the smallest of 8/16/32/64 entries that holds the
    plain walk's stack; the stack lies in local memory, so the launch's
    shared memory is the scene's alone."""
    inst = megakernel.tree_instance(cap)
    assert inst in megakernel.TREE_STACK_CAPS and inst >= cap
    assert inst == 8 or inst // 2 < cap
    # the kernel refuses a stack that (max_depth + 1)(m - 1) entries do not
    # fit: the walk's cap - 1, the node in registers not counted
    assert cap - 1 <= inst


def test_tree_instance_refuses_deep_stacks():
    """No stack is refused but an empty one: a stack above 64 entries
    takes the 128- or 256-entry instance, above 256 the slab
    (tests/test_torch_deep_tree.py)."""
    assert megakernel.tree_instance(65) == 128
    assert megakernel.tree_instance(257) == megakernel.TREE_SLAB
    with pytest.raises(ValueError):
        megakernel.tree_instance(0)
    # the scenes of the card tests take the instances 8, 16, 32 and 64
    scenes = (load_scene_file(SHOWCASE, device="cpu"), _indirect_scene(4, 4),
              _indirect_scene(8, 2), _indirect_scene(24, 1))
    stacks = [integrator.tree_loop_stack(sc.spec) for sc in scenes]
    assert [megakernel.tree_instance(st[3]) for st in stacks] == [8, 16, 32,
                                                                 64]
    for sc, (m, levels, _, cap) in zip(scenes, stacks):
        assert cap == 1 + (levels - 1) * (m - 1)
        assert levels == sc.spec.max_depth + 2
    # a block's dynamic shared memory: header, lights and a small scene's
    # rows; a large scene's rows stay in device memory
    assert megakernel.scene_shared_bytes(scenes[0].spec) == 4 * (
        24 + 16 * 3 + 24 * 4)
    field = make_sphere_field(70, device="cpu").spec
    assert megakernel.is_large(field)
    assert megakernel.scene_shared_bytes(field) == 4 * 24


# ---- (c), (d) the work counters and the live-only walk


def _walk_live_only(data, spec, lane_ids, seed):
    """One lane's walk as the tree kernel does it: the node in hand, its
    first live child next, the others pushed so that they pop in slot
    order, dead subtrees never touched.  Returns (radiance as three
    float32, [(depth, ray origin and direction)] of the nodes run)."""
    m, levels, _, cap = integrator.tree_loop_stack(spec)
    ro, rd, k1, k2 = integrator.primary_rays(data, spec, *lane_ids, seed)
    one = torch.ones_like(ro.x)
    e = integrator.tree_loop_entry(ro, rd, one, V3(one, one, one), one, k1,
                                   k2, ro.x.dtype)
    depth, stack, nodes = 0, [], []
    acc = [torch.zeros_like(ro.x) for _ in range(3)]
    while True:
        nodes.append((depth, [float(c) for c in e[:6]]))
        contrib, virt = integrator.tree_loop_node(data, spec, m, e, depth)
        acc = [a + c for a, c in zip(acc, contrib)]
        live = [v for v in virt if float(v[10]) > 0.5]
        pushed = [(depth + 1, v) for v in live[1:]]
        stack += pushed[::-1]
        assert len(stack) <= cap - 1
        if live:
            e, depth = live[0], depth + 1
        elif stack:
            depth, e = stack.pop()
        else:
            return [float(a) for a in acc], nodes


def test_showcase_work_counters_match_a_live_only_walk():
    """On a 16x16 image of the showcase, lane by lane: the kernel's walk
    (live children only, the first kept, the others pushed in reverse)
    gives radiance_tree_loop_v's radiance to the bit and never needs more
    than cap - 1 stack entries; path_work's live nodes per lane and the
    per-warp maximum equal the counts of those walks."""
    sc = load_scene_file(SHOWCASE, device="cpu")
    spec = dataclasses.replace(sc.spec, width=16, height=16)
    pix = torch.arange(256, dtype=torch.int64)
    lanes = [pix % 16, pix // 16, torch.zeros_like(pix), pix % 4]
    ro, rd, k1, k2 = integrator.primary_rays(sc.data, spec, *lanes, 4)
    want = integrator.radiance_tree_loop_v(sc.data, spec, ro, rd, k1, k2)
    counts = []
    for i in range(256):
        rad, nodes = _walk_live_only(sc.data, spec,
                                     [t[i:i + 1] for t in lanes], 4)
        assert rad == [float(c[i]) for c in want], i
        counts.append(len(nodes))
    counts = np.array(counts)
    got = work.path_work(sc.data, spec, lanes, 4)
    assert got["visits"] == counts.mean() and 2 < got["visits"] < 63
    assert got["warp_visits"] == counts.reshape(8, 32).max(axis=1).mean()
    assert got["warp_visits"] > got["visits"]
    assert got["most"] == counts.max()
    assert (got["chunks"], got["misses"], got["by_depth"]) == (0.0, 0.0, {})


def _full_tree_counts(data, spec, lanes, seed):
    """path_work's counts of a small scene by a walk of every position of
    the full tree, depth first, all the lanes at a position in one batch,
    the dead ones masked: live nodes per lane, hits, the last depth's hits
    and the misses (counted whatever the background)."""
    m, levels, _, cap = integrator.tree_loop_stack(spec)
    ro, rd, k1, k2 = integrator.primary_rays(data, spec, *lanes, seed)
    one = torch.ones_like(ro.x)
    stack = [integrator.tree_loop_entry(ro, rd, one, V3(one, one, one), one,
                                        k1, k2, ro.x.dtype)] + [None] * cap
    per_lane = torch.zeros_like(ro.x, dtype=torch.int64)
    hits = last_hits = misses = 0
    sp = 1
    for depth in integrator._dfs_schedule(m, levels):
        sp -= 1
        e = stack[sp]
        live = e[10] > 0.5
        per_lane += live
        hit = intersect.closest_hit(data, spec, V3(*e[0:3]),
                                    V3(*e[3:6])).hit & live
        hits += int(hit.sum())
        misses += int((live & ~hit).sum())
        if depth == levels - 1:
            last_hits += int(hit.sum())
        else:
            _, virt = integrator.tree_loop_node(data, spec, m, e, depth)
            if len(virt) < m:
                break
            for j, child in enumerate(virt):
                stack[sp + (m - 1 - j)] = child
            sp += m
    return per_lane, hits, last_hits, misses


@pytest.mark.parametrize("scene", ["showcase", "indirect 4 x 3",
                                   "indirect 3 x 2 under the sky"])
def test_live_work_matches_path_work(scene):
    """path_work's walk of a small scene, breadth first over the live
    nodes alone, counts what a walk of every position of the full tree
    counts: live nodes per lane (their mean, a warp's largest, any lane's
    most), hits, the last depth's hits and, under the sky, the skybox's
    misses; no chunks."""
    if scene == "showcase":
        sc = load_scene_file(SHOWCASE, device="cpu")
    else:
        sc = _indirect_scene(*(int(c) for c in scene.split()[1:4:2]))
    spec = dataclasses.replace(sc.spec, width=16, height=16)
    data = sc.data
    if "sky" in scene:
        spec = dataclasses.replace(spec, bg_type=BG_SKYBOX,
                                   face_sizes=((4, 4),) * 6)
        data = dataclasses.replace(data, bg_cube=torch.rand(
            (6, 4, 4, 3), generator=torch.Generator().manual_seed(0)))
    pix = torch.arange(256, dtype=torch.int64)
    lanes = [pix % 16, pix // 16, torch.zeros_like(pix), pix % 4]
    per_lane, hits, last_hits, misses = _full_tree_counts(data, spec, lanes, 4)
    got = work.path_work(data, spec, lanes, 4)
    assert got == {
        "visits": float(per_lane.sum()) / 256,
        "warp_visits": float(per_lane.reshape(8, 32).amax(dim=1)
                             .double().mean()),
        "most": int(per_lane.max()),
        "misses": misses / 256 if "sky" in scene else 0.0,
        "hits": hits / 256, "last_hits": last_hits / 256, "chunks": 0.0,
        "fold_chunks": 0.0, "by_depth": {}}
    assert got["visits"] > 2 and (got["misses"] > 0) == ("sky" in scene)


@pytest.mark.parametrize("mix", [False, True])
def test_field_work_counters_match_brute_force(mix):
    """On a 16x16 image of a 70-object field: every live node's ray, found
    by the lane-by-lane walk, held against the chunk bounds as a thread of
    the kernel does; the
    chunks it enters, summed per lane and per depth, and their union over
    each 32 consecutive lanes at the same position of the tree, equal
    path_work's counters: ``chunks`` and ``by_depth`` under the scene-order
    table (``_packed_tables`` with its ``_chunk_bounds``), ``fold_chunks``
    under the compact one that the kernels fold (``scene_tables``)."""
    sc = make_sphere_field(64, mix_materials=mix, device="cpu")
    assert len(sc.spec.live_objects()) == 70
    spec = dataclasses.replace(sc.spec, width=16, height=16)
    compact = scene_tables(sc.data, spec)
    table, n_sph_pad, ids = intersect._packed_tables(sc.data, spec)
    scene_order = intersect_scan._chunk_bounds(table, n_sph_pad,
                                               table.shape[0] // 32)
    tb = compact._replace(table=table, ids=ids, bounds=scene_order)
    _, rows, _, bounds = _fold_parts(tb)
    _, fold_rows, _, fold_bounds = _fold_parts(compact)
    n_sph_chunks = tb.n_sph_pad // 32
    n = 64 if mix else 256
    pix = torch.arange(n, dtype=torch.int64) * (256 // n)
    lanes = [pix % 16, pix // 16, torch.zeros_like(pix),
             torch.zeros_like(pix)]
    levels = spec.max_depth + 2
    visits = np.zeros(n, np.int64)
    live = np.zeros(levels, np.int64)
    chunks = np.zeros(levels, np.int64)
    fold_chunks = 0
    for i in range(n):
        _, nodes = _walk_live_only(sc.data, spec, [t[i:i + 1] for t in lanes],
                                   9)
        visits[i] = len(nodes)
        for depth, ray in nodes:
            live[depth] += 1
            chunks[depth] += len(_chunks_entered(
                rows, bounds, n_sph_chunks, _make_ray(ray[:3], ray[3:])))
            fold_chunks += len(_chunks_entered(
                fold_rows, fold_bounds, n_sph_chunks,
                _make_ray(ray[:3], ray[3:])))
    got = work.path_work(sc.data, spec, lanes, 9)
    assert got["visits"] == visits.mean()
    assert got["warp_visits"] == visits.reshape(-1, 32).max(axis=1).mean()
    assert got["most"] == visits.max()
    assert got["chunks"] == chunks.sum() / n and got["chunks"] > 1
    assert got["fold_chunks"] == fold_chunks / n and got["fold_chunks"] > 1
    for d, (share, per_lane, union) in got["by_depth"].items():
        assert share == live[d] / n and per_lane == chunks[d] / live[d]
        assert per_lane <= union <= min(32 * per_lane, n_sph_chunks)
    assert sorted(got["by_depth"]) == [d for d in range(levels) if live[d]]
    if not mix:
        # a linear scene's lanes sit at one position per depth: the union
        # by brute force, from the plain scan's mask of each depth's rays
        ro, rd, k1, k2 = integrator.primary_rays(sc.data, spec, *lanes, 9)
        one = torch.ones_like(ro.x)
        e = integrator.tree_loop_entry(ro, rd, one, V3(one, one, one), one,
                                       k1, k2, ro.x.dtype)
        for d in range(levels):
            mask = intersect_scan.scan_hit_reference(
                tb.table, tb.ids, tb.n_sph_pad, V3(*e[0:3]), V3(*e[3:6]),
                tb.bounds, return_mask=True)[3].numpy()
            alive = e[10].numpy() > 0.5
            unions, warps = 0, 0
            for w in range(0, n, 32):
                seen = set()
                for i in range(w, w + 32):
                    if alive[i]:
                        seen |= set(np.nonzero(mask[i])[0])
                unions += len(seen)
                warps += bool(alive[w:w + 32].any())
            if warps:
                assert got["by_depth"][d][2] == unions / warps
            _, virt = integrator.tree_loop_node(sc.data, spec, 1, e, d)
            if d < levels - 1:
                e = virt[0]


def test_live_only_preorder_sums_to_the_same_bits():
    """What the tree kernel's walk rests on, on 512 showcase lanes: adding
    only the live nodes' contributions, in the plain walk's preorder, gives
    radiance_tree_loop_v's sum to the bit (a dead node adds exact zeros)."""
    sc = load_scene_file(SHOWCASE, device="cpu")
    spec = sc.spec
    rs = np.random.RandomState(12)
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in (
        rs.randint(0, spec.width, 512), rs.randint(0, spec.height, 512),
        rs.randint(0, 64, 512), rs.randint(0, spec.cam_samples, 512))]
    ro, rd, k1, k2 = integrator.primary_rays(sc.data, spec, *lanes, 12)
    want = integrator.radiance_tree_loop_v(sc.data, spec, ro, rd, k1, k2)
    m, levels, n_nodes, cap = integrator.tree_loop_stack(spec)
    assert (m, levels, n_nodes, cap) == (2, 6, 63, 6)
    one = torch.ones_like(ro.x)
    stack = [None] * cap
    stack[0] = integrator.tree_loop_entry(ro, rd, one, V3(one, one, one), one,
                                          k1, k2, ro.x.dtype)
    acc = [torch.zeros_like(ro.x) for _ in range(3)]
    sp, n_live = 1, 0
    for depth in integrator._dfs_schedule(m, levels):
        sp -= 1
        e = stack[sp]
        live = e[10] > 0.5
        n_live += int(live.sum())
        contrib, virt = integrator.tree_loop_node(sc.data, spec, m, e, depth)
        acc = [torch.where(live, a + c, a) for a, c in zip(acc, contrib)]
        if depth < levels - 1:
            for j, entry in enumerate(virt):
                stack[sp + (m - 1 - j)] = entry
            sp += m
    assert 512 * 2 < n_live < 512 * 10  # most of the 63 nodes are dead
    for a, w in zip(acc, want):
        np.testing.assert_array_equal(a.numpy().view(np.int32),
                                      w.numpy().view(np.int32))


def test_warp_sample_takes_whole_warps():
    """Whole warps in order, the same ones for every tensor of a length,
    spread over every column of a pixel-ordered launch (an even stride of
    128 warps would see one column of a 1024-wide image in 16)."""
    t = torch.arange(32 * 65536 + 7)
    s = work.warp_sample(t, 512).reshape(512, 32)
    assert (s[:, 1:] - s[:, :-1] == 1).all() and (s[:, 0] % 32 == 0).all()
    assert (s[1:, 0] > s[:-1, 0]).all()
    assert torch.equal(work.warp_sample(t + 5, 512), s.reshape(-1) + 5)
    columns = (s[:, 0] // 2) % 1024  # 2 samples a pixel, 1024 pixels a row
    assert len(set((columns // 64).tolist())) == 16
    assert work.warp_sample(torch.arange(70), 512).shape == (64,)
    with pytest.raises(ValueError, match="whole warps"):
        work.path_work(None, None, [torch.arange(33)], 0)


@pytest.mark.parametrize("id_bytes", [4, 8])
def test_ring_start_bound_counts_operations(id_bytes):
    """``ring_start``'s bound on cornell at 2,097,152 lanes: each lane's
    primary ray, 32 FP32, 1 special-function and 154 integer operations
    (its keys' hashes the most), over each unit's peak, against its ids
    (4 of ``id_bytes``) in and 72 B of state out, the header once; bytes
    bound it.  The depth-of-field camera adds the lens sample's."""
    from raytrace_tpu_torch.utils import flops
    from raytrace_tpu_torch.utils.gpu_info import H100_SXM

    n = 1 << 21
    cornell = load_scene_file(str(repo_path("examples",
                                            "cornell_indirect.txt")),
                              device="cpu")
    assert flops.k1_primary_ops(cornell.spec).tolist() == [32, 1, 154]
    show = load_scene_file(SHOWCASE, device="cpu")
    assert flops.k1_primary_ops(show.spec).tolist() == [63, 4, 192]
    ms, by, units = flops.ring_start_bound(cornell.spec, n, id_bytes)
    nbytes = (4 * id_bytes + 72) * n + 4 * 24
    assert by == "bytes" and ms == units["bytes"]
    assert units["bytes"] == pytest.approx(nbytes / 3.35e12 * 1e3)
    assert units["int32"] == pytest.approx(154 * n / H100_SXM.int_ops * 1e3)
    assert units["int32"] < units["bytes"] / 2
    assert ms == pytest.approx(0.0551 if id_bytes == 4 else 0.0651,
                               abs=1e-4)


# ---- on the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["showcase", "4 samples", "8 samples",
                                   "24 samples"])
def test_tree_kernel_bit_equal_per_stack_instance_on_card(cuda_device, scene):
    """The tree kernel equals radiance_tree_loop_v to the bit in each of
    its stack instances (8, 16, 32, 64 entries)."""
    sc = {"showcase": lambda: load_scene_file(SHOWCASE, device=cuda_device),
          "4 samples": lambda: _indirect_scene(4, 4, cuda_device),
          "8 samples": lambda: _indirect_scene(8, 2, cuda_device),
          "24 samples": lambda: _indirect_scene(24, 1, cuda_device)}[scene]()
    rs = np.random.RandomState(3)
    n = 8192 if scene == "showcase" else 2048
    lanes = [torch.from_numpy(a.astype(np.int64)).to(cuda_device) for a in (
        rs.randint(0, sc.spec.width, n), rs.randint(0, sc.spec.height, n),
        rs.randint(0, 1 << 16, n), rs.randint(0, sc.spec.cam_samples, n))]
    before = _build.LAUNCHES[_build.KERNEL_TREE]
    got = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 6)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[_build.KERNEL_TREE] == before + 1
    want = megakernel.radiance_lanes_reference(sc.data, sc.spec, *lanes, 6)
    for g, w in zip(got, want):
        assert torch.equal(g, w) and bool(torch.isfinite(g).all())
    assert float(got.x.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("rays", ["incoherent", "coherent"])
@pytest.mark.parametrize("table", ["field", "large field", "ties"])
def test_fold_instances_equal_plain_scan_on_card(cuda_device, table, rays):
    """The scan kernel with the table staged in shared memory (1,006
    objects, and the tie table) and read from device memory (4,006
    objects), on rays that part, which the warps fold one at a time, and on
    rays that run together, which every thread folds for itself: ids and
    hits equal to the plain scan's and t to the bit, with dead lanes and a
    ragged last warp, on pad rows, and on exact ties across chunks."""
    if table == "ties":
        tie = _tie_table()
        tb = tie._replace(table=tie.table.to(cuda_device),
                          ids=tie.ids.to(cuda_device),
                          bounds=tie.bounds.to(cuda_device))
        ro, rd = _aimed_rays(tie, 4096 + 13, 8)
    else:
        n_obj = 1000 if table == "field" else 4000
        ts = make_sphere_field(n_obj, mix_materials=False, device=cuda_device)
        tb = scene_tables(ts.data, ts.spec)
        ro, rd = _incoherent_rays(8192 + 13, 4)
    n_chunks = tb.table.shape[0] // 32
    assert intersect_scan.fold_in_shared(n_chunks) == (table != "large field")
    if rays == "coherent":
        # each warp's 32 rays leave one point in nearly one direction
        ro, rd = ro.copy(), rd.copy()
        lead = (np.arange(len(ro)) // 32) * 32
        ro = ro[lead]
        rd = (rd[lead] * (1 + 1e-3 * np.random.RandomState(9).normal(
            0, 1, rd.shape))).astype(F32)
    args = (tb.table, tb.ids, tb.n_sph_pad,
            V3(*(c.to(cuda_device) for c in _v3(ro, torch))),
            V3(*(c.to(cuda_device) for c in _v3(rd, torch))), tb.bounds)
    before = _build.LAUNCHES[_build.KERNEL_SCAN]
    t, gid, hit = intersect_scan.scan_hit(*args)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[_build.KERNEL_SCAN] == before + 1
    wt, wg, wh = intersect_scan.scan_hit_reference(*args)
    assert torch.equal(hit, wh) and torch.equal(gid, wg)
    assert torch.equal(t, wt) and float(hit.float().mean()) > 0.3
