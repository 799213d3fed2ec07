"""Object-sharded ring intersection.

PyTorch counterpart of :mod:`raytrace_tpu.parallel.ring`.  The scene's
objects are split into k shards, one per rank, and circulated around the
ring of ranks: at each of the k steps a rank intersects its rays with the
shard it holds, folds the result into a running ``(t, id)`` minimum (an
associative reduction, so the ring is exact whatever the order) and
hands the shard to rank + 1.  After k steps every ray has met every
object while a rank held 1/k of the geometry at a time.

A step is :func:`raytrace_tpu_torch.ops.intersect_scan.scan_hit`: the
CUDA scan kernel on CUDA float32 tensors, the plain scan on CPU tensors.
What it reads circulates with the shard, built once per shard: the table
(for the plain scan) and its fold buffer (the kernel's layout of the
table, which holds the ids and the chunk bounds too).  The winners'
material rows, in the render kernels' row layout, come round a second
ring of the packed object table's row shards.

A ring render (:func:`render_image_ring`) installs a :class:`RingContext`
(:func:`raytrace_tpu_torch.ops.intersect.set_ring_ctx`) and replaces the
scene's per-object leaves by one-row dummies.  On CUDA tensors the lanes
then go through the ring instances of the render kernels
(:mod:`raytrace_tpu_torch.render.ring_shade`), one node of every lane a
round, with this module's round loop, :func:`ring_radiance`, between
their launches: the closest hit round the ring, the winners' rows, and
the shadow rays round the ring.  On CPU tensors every closest-hit and
shadow query of the plain chain or DFS goes round the ring, and a
skybox's misses through
:func:`raytrace_tpu_torch.models.backgrounds.background_color`.
"""

from __future__ import annotations

import contextlib
import dataclasses
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from raytrace_tpu_torch.ops import intersect, intersect_scan
from raytrace_tpu_torch.ops.intersect_scan import OBJ_CHUNK
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.parallel.mesh import (Mesh, all_gather,
                                              all_reduce_max, make_mesh,
                                              replicated, ring_shift)
from raytrace_tpu_torch.render.megakernel import kernel_rows
from raytrace_tpu_torch.scene.schema import (LIGHT_DIRECTIONAL, Scene,
                                             SceneData, SceneSpec)


def shard_geometry(data: SceneData, spec: SceneSpec, k: int):
    """Split the scene into k equal unified-table object shards.

    Returns ``(tables (k, C, 4), ids (k, C) int32, n_sph_pad)``: every
    shard holds ``n_sph_pad`` sphere rows ``(cx, cy, cz, r)``, then its
    plane rows ``(n, p.n)``, each partition chunk-aligned; zero pad rows
    carry id -1.  At k = 1 this is the dense scan's table
    (:func:`raytrace_tpu_torch.ops.intersect._packed_tables`)."""
    sph, pln = intersect._typed_geometry(spec)

    def shard_rows(rows, idx):
        o = rows.shape[0]
        per = -(-max(o, 1) // k)
        per = -(-per // OBJ_CHUNK) * OBJ_CHUNK
        pad = per * k - o
        rows = torch.cat([rows, rows.new_zeros((pad, 4))])
        idx = np.concatenate([idx, np.full(pad, -1, np.int64)])
        return rows.reshape(k, per, 4), idx.reshape(k, per), per

    sph_rows = torch.cat([data.prim_p[sph], data.prim_q[sph, 0:1]], dim=1)
    pn = torch.sum(data.prim_p[pln] * data.prim_q[pln], dim=1, keepdim=True)
    pln_rows = torch.cat([data.prim_q[pln], pn], dim=1)
    sph_rows, sph_ids, n_sph_pad = shard_rows(sph_rows, sph)
    pln_rows, pln_ids, _ = shard_rows(pln_rows, pln)
    ids = torch.from_numpy(np.concatenate([sph_ids, pln_ids], axis=1)
                           .astype(np.int32)).to(data.device)
    return torch.cat([sph_rows, pln_rows], dim=1), ids, n_sph_pad


class RingShard(NamedTuple):
    """One object shard as it circulates: what a ring step reads."""

    table: torch.Tensor   # (C, 4) unified rows
    fold: torch.Tensor    # its fold buffer: the rows in the scan kernel's
                          # layout, the int32 global ids (-1 on pad rows)
                          # and the chunk bounds


def make_shard(table, ids, n_sph_pad: int) -> RingShard:
    """A shard with its fold buffer, built once."""
    bounds = intersect_scan._chunk_bounds(table, n_sph_pad,
                                          table.shape[0] // OBJ_CHUNK)
    return RingShard(table, intersect_scan.fold_buffer(table, ids, n_sph_pad,
                                                       bounds))


def _shard_hit(shard: RingShard, n_sph_pad: int, ro: V3, rd: V3):
    """(t, global obj id, hit) of one resident shard against (N,) rays.
    The scan folds on global ids, so within a shard an exact t tie goes
    to the lowest global id (scene.rs:248); the ring's fold does the
    same across shards."""
    ids, bounds = intersect_scan.fold_ids_bounds(shard.fold, shard.table)
    return intersect_scan.scan_hit(shard.table, ids, n_sph_pad, ro, rd,
                                   bounds, shard.fold)


def ring_closest_hit_local(shard: RingShard, n_sph_pad: int, ro: V3, rd: V3,
                           mesh: Mesh):
    """The ring: this rank's (N,) rays against every rank's shard, which
    circulate ``mesh.ranks`` times.  Returns ``(t (N,), obj (N,) int32,
    hit (N,))`` with the first minimum in scene order winning: on an exact
    t tie the lower global id (scene.rs:248).  Miss lanes carry obj 0."""
    for step in range(mesh.ranks):
        t_s, gid, h_s = _shard_hit(shard, n_sph_pad, ro, rd)
        t_s = torch.where(h_s, t_s, float("inf"))
        if step == 0:
            # the first shard's answer is the running minimum so far (a
            # miss carries t = inf and the sentinel id)
            t_best, obj, hit = t_s, gid, h_s
        else:
            better = (t_s < t_best) | ((t_s == t_best) & h_s & (gid < obj))
            t_best = torch.where(better, t_s, t_best)
            obj = torch.where(better, gid, obj)
            hit = hit | h_s
        if step + 1 < mesh.ranks:
            shard = RingShard(*ring_shift(shard, mesh))
    return t_best, torch.where(hit, obj, 0), hit


class RingContext(NamedTuple):
    """What a rank holds while it renders with its objects sharded,
    installed by :func:`ring_context`."""

    mesh: Mesh
    shard: RingShard        # this rank's geometry shard
    n_sph_pad: int          # sphere rows of every shard
    mat_rows: torch.Tensor  # (per, 24) this rank's rows of the packed
                            # object table in the kernels' row layout
                            # (megakernel.kernel_rows): rows [rank*per,
                            # (rank+1)*per)


def ring_gather_rows(mat_rows, obj, mesh: Mesh):
    """The winners' rows of the packed object table, whose contiguous row
    shards circulate: each lane takes its row while the shard that owns it
    is resident.  (N, 24) rows in the render kernels' layout for (N,)
    lanes.  On CUDA tensors each step is the ring's row kernel
    (:func:`raytrace_tpu_torch.render.ring_shade.gather_rows`), whose
    gradient in the rows is its plain select's; on CPU tensors the plain
    version, :func:`ring_gather_rows_reference`.  Differentiable in the
    rows: every rank of the ring then calls ``backward()`` together."""
    from raytrace_tpu_torch.render import ring_shade

    if obj.device.type == "cpu":
        return ring_gather_rows_reference(mat_rows, obj, mesh)

    # no copy where obj is int32 already, as ring_closest_hit_local makes
    # it: at k = 1 without grad the call launches ring_rows alone
    ids = obj.to(torch.int32)
    k, per = mesh.ranks, mat_rows.shape[0]
    grad = torch.is_grad_enabled() and mat_rows.requires_grad
    # every lane's row lies in some shard: the steps overwrite every lane
    out = mat_rows.new_empty(obj.shape + mat_rows.shape[1:])
    rows = mat_rows
    for step in range(k):
        src = (mesh.rank - step) % k

        def kernel(r, o, src=src):
            # a step writes into its own copy where a backward keeps the
            # step's inputs
            o = o.clone() if grad else o
            ring_shade.gather_rows(r, src * per, ids, o)
            return (o,)

        out, = kernel_forward(
            kernel, lambda r, o, src=src: (_select_rows(r, obj, src, o),),
            rows, out, name=ring_shade.KERNEL_RING)
        if step + 1 < k:
            rows, = ring_shift([rows], mesh)
    return out


def _select_rows(rows, obj, src: int, out):
    """One ring step's rows by pure selects (exact): the lanes whose
    winner lies in the resident shard ``src`` take its row, the others
    keep ``out``'s."""
    per = rows.shape[0]
    local = obj - src * per
    mine = (local >= 0) & (local < per)
    return torch.where(mine[..., None], rows[local.clamp(0, per - 1)], out)


def ring_gather_rows_reference(mat_rows, obj, mesh: Mesh):
    """The plain :func:`ring_gather_rows`: each step's rows taken by pure
    selects (exact)."""
    k = mesh.ranks
    out = mat_rows.new_zeros(obj.shape + mat_rows.shape[1:])
    rows = mat_rows
    for step in range(k):
        out = _select_rows(rows, obj, (mesh.rank - step) % k, out)
        if step + 1 < k:
            rows, = ring_shift([rows], mesh)
    return out


def ring_closest_hit(ctx: RingContext, ro: V3, rd: V3):
    """Closest hit through the ring, lanes of any shape: the intersection
    ring, the material-row ring, and the hit record as the dense scan
    makes it (:func:`raytrace_tpu_torch.ops.intersect.large_scene_rec`),
    so the same bits as the dense path."""
    t_best, obj, hit = intersect.flat_scan(
        partial(ring_closest_hit_local, ctx.shard, ctx.n_sph_pad,
                mesh=ctx.mesh), ro, rd)
    rows = ring_gather_rows(ctx.mat_rows, obj, ctx.mesh)
    return intersect.large_scene_rec(rows, t_best, obj, hit, ro, rd)


def ring_occluded(ctx: RingContext, ro: V3, rd: V3, sq_range,
                  has_range: bool):
    """Shadow query through the ring (raytrace.rs:43-50)."""
    t_best, _, hit = intersect.flat_scan(
        partial(ring_closest_hit_local, ctx.shard, ctx.n_sph_pad,
                mesh=ctx.mesh), ro, rd)
    return hit & (t_best * t_best < sq_range) if has_range else hit


def shard_object_table(table: torch.Tensor, k: int) -> torch.Tensor:
    """The (O, C) packed object table padded to k contiguous row shards,
    (k, per, C); pad rows are never selected (obj < O)."""
    o = table.shape[0]
    per = -(-o // k)
    table = torch.cat([table, table.new_zeros((per * k - o,
                                               table.shape[1]))])
    return table.reshape(k, per, table.shape[1])


# the per-object leaves: what the ring shards, and what a ring render
# replaces by one-row dummies
OBJECT_LEAVES = ("prim_p", "prim_q", "mat_diffuse", "mat_specular",
                 "mat_ambient", "mat_exponent", "mat_ior", "mat_samples")


def strip_object_data(data: SceneData) -> SceneData:
    """The per-object leaves replaced by one-row dummies: under a ring
    context the shading reads only light, camera and background leaves."""
    return dataclasses.replace(data, **{
        n: getattr(data, n).new_zeros((1, *getattr(data, n).shape[1:]))
        for n in OBJECT_LEAVES})


@contextlib.contextmanager
def ring_context(data: SceneData, spec: SceneSpec, mesh: Mesh):
    """Install this rank's ring context (its geometry and object-table
    shards of ``data``, on ``mesh``'s device) for the duration; yields the
    stripped data to render with.  The shards are differentiable in the
    per-object leaves: a loss of :func:`ring_closest_hit`'s records on each
    rank's lanes, ``backward()`` on every rank together, gives every rank
    the gradient of the sum of the ranks' losses."""
    if data.device != mesh.device:
        raise ValueError(f"scene on {data.device}, this rank renders on "
                         f"{mesh.device}")
    k = mesh.ranks
    # every rank holds the per-object leaves alike and shards them: each
    # rank's gradient in them is the sum of the ranks'
    shared = dataclasses.replace(data, **dict(zip(OBJECT_LEAVES, replicated(
        mesh, *(getattr(data, n) for n in OBJECT_LEAVES)))))
    tables, ids, n_sph_pad = shard_geometry(shared, spec, k)
    mats = shard_object_table(
        kernel_rows(intersect.object_table(shared, spec)), k)
    ctx = RingContext(mesh, make_shard(tables[mesh.rank].clone(),
                                       ids[mesh.rank].clone(), n_sph_pad),
                      n_sph_pad, mats[mesh.rank].clone())
    prev = intersect.set_ring_ctx(ctx)
    try:
        yield strip_object_data(data)
    finally:
        intersect.set_ring_ctx(prev)


def refuse_grad(ctx: RingContext, data: SceneData) -> None:
    """Raise ``NotImplementedError`` where a gradient is wanted of the
    ring's round loop: in grad mode, a leaf of ``data`` or of ``ctx``'s
    shards requires grad.  The loop is forward only (ROADMAP item 13), and
    a radiance whose gradient is silently missing is never returned."""
    leaves = [getattr(data, f.name) for f in dataclasses.fields(data)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (*leaves, ctx.shard.table, ctx.mat_rows)):
        raise NotImplementedError(
            "the ring's round loop is forward only: no gradient flows "
            "through ring_radiance (ROADMAP item 13); take gradients "
            "through ring_closest_hit or make_ring_intersector")


def ring_radiance(ctx: RingContext, data: SceneData, spec: SceneSpec, pix,
                  piy, aa, cam, seed: int, step=None) -> V3:
    """Radiance of (N,) lanes through the ring, one node of every lane a
    round: ``step.start`` makes the primary rays, then each round takes
    the ring's closest hit of the nodes (K5 on each resident shard), the
    winners' rows, for a lit scene ``step.shadow``'s shadow rays and their
    blocked bits round the ring (:func:`ring_occluded`), and
    ``step.finish``.  A linear scene takes
    ``max_depth + 2`` rounds (one where no material spawns a child, as the
    plain chain does); a fan-out scene takes rounds while any rank
    has a live lane, which a MAX all-reduce of the ranks' counts decides
    once a round, so that every rank makes the same ring steps.  ``step``
    is a :class:`raytrace_tpu_torch.render.ring_shade.RingStep`: by
    default the ring kernels (CUDA tensors; their plain twin on CPU
    tensors); every rank of the ring calls this together.  Forward only:
    it raises where a gradient is wanted in the scene (ROADMAP item 13)."""
    from raytrace_tpu_torch.render import ring_shade

    refuse_grad(ctx, data)
    step = ring_shade.ring_shade_kernels if step is None else step
    lanes = step.start(data, spec, pix, piy, aa, cam, seed)
    tree = spec.children_per_ray > 1
    rounds = spec.max_depth + 2 if spec.children_per_ray else 1
    ranged = [lt != LIGHT_DIRECTIONAL for lt in spec.light_type]
    depth = 0
    while (all_reduce_max(int(lanes.live.sum()), ctx.mesh) > 0 if tree
           else depth < rounds):
        ro, rd = lanes.rays()
        t, obj, hit = ring_closest_hit_local(ctx.shard, ctx.n_sph_pad, ro, rd,
                                             ctx.mesh)
        rows = step.rows(ctx.mat_rows, obj, ctx.mesh)
        blocked = None
        # a linear scene's last round shades past max_depth: no lights
        if spec.n_lights and (tree or depth <= spec.max_depth):
            # per light (origin, direction, squared range) of each lane
            q = step.shadow(data, spec, lanes, t, hit, rows)
            blocked = torch.stack([
                ring_occluded(ctx, V3(*q[li, :3]), V3(*q[li, 3:6]), q[li, 6],
                              ranged[li]) for li in range(spec.n_lights)])
        step.finish(data, spec, lanes, t, hit, rows, blocked)
        depth += 1
    return V3(*lanes.acc)


def render_image_ring(scene: Scene, *, seed: int = 0,
                      spp: int | None = None, mesh: Mesh | None = None,
                      max_lanes: int = 1 << 22, progress=None,
                      checkpoint: str | None = None) -> np.ndarray:
    """Full-image render with the OBJECT set ring-sharded over the mesh's
    ranks and the pixels sharded as in
    :func:`raytrace_tpu_torch.parallel.tile.render_image_sharded`: no rank
    holds more than 1/k of the geometry and material tables while it
    renders.  The same image as the dense render, to the bit on the CPU:
    the RNG is keyed by identity and the ring's fold is the dense scan's
    (t, id) minimum.  Every rank calls it and gets the whole image; rank 0
    alone writes and reads the checkpoint."""
    from raytrace_tpu_torch.render import ring_shade
    from raytrace_tpu_torch.render.integrator import _image_loop

    mesh = mesh if mesh is not None else make_mesh(scene.data.device)
    if len(mesh.axis_names) > 1:
        raise ValueError("ring rendering wants a flat 1-axis mesh; got "
                         + str(mesh.axis_names))
    with ring_context(scene.data, scene.spec, mesh) as stripped:
        # launches sized for the ring kernels' lane state: one lane a
        # primary sample, and a fan-out scene's DFS stacks within their
        # budget
        return _image_loop(dataclasses.replace(scene, data=stripped),
                           seed=seed, spp=spp,
                           max_lanes=ring_shade.max_lanes(
                               scene.spec, max_lanes) * mesh.ranks,
                           progress=progress, checkpoint=checkpoint,
                           mesh=mesh)


def make_ring_intersector(spec: SceneSpec, mesh: Mesh):
    """End-to-end ring intersection over ``mesh``: returns ``fn(data, ro
    (N, 3), rd (N, 3)) -> (t, obj, hit)`` with the rays and the objects
    both sharded over the ranks (N divisible by their count); every rank
    calls it and gets every ray's result.  Differentiable in ``t`` as
    JAX's is: where every rank takes the same loss of the result and calls
    ``backward()`` together, each rank's gradients in ``data.prim_p``,
    ``data.prim_q``, ``ro`` and ``rd`` are the dense closest hit's."""
    k = mesh.ranks

    def run(data: SceneData, ro, rd):
        if ro.shape[0] % k:
            raise ValueError(f"{ro.shape[0]} rays over {k} ranks")
        prim_p, prim_q, ro, rd = replicated(mesh, data.prim_p, data.prim_q,
                                            ro, rd)
        data = dataclasses.replace(data, prim_p=prim_p, prim_q=prim_q)
        tables, ids, n_sph_pad = shard_geometry(data, spec, k)
        shard = make_shard(tables[mesh.rank], ids[mesh.rank], n_sph_pad)
        per = ro.shape[0] // k
        lo, hi = mesh.rank * per, (mesh.rank + 1) * per
        t, obj, hit = ring_closest_hit_local(
            shard, n_sph_pad, V3(*ro[lo:hi].unbind(1)),
            V3(*rd[lo:hi].unbind(1)), mesh)
        return (torch.cat(all_gather(t, mesh)),
                torch.cat(all_gather(obj, mesh)),
                torch.cat(all_gather(hit.to(torch.uint8), mesh)).bool())

    return run
