"""The ring instances of the render kernels: K1's chain and K3's walk one
node a launch, with the queries of each node answered by the ring.

An object-sharded render (:mod:`raytrace_tpu_torch.parallel.ring`) holds no
scene in a kernel: the closest hit of a ray and each shadow ray's answer
are minima over object shards that circulate round the ranks.  So the
per-lane loop of the render kernels is cut at the node body's two
questions (``shade_node`` in ``csrc/render_common.cuh``), and the round
loop, :func:`raytrace_tpu_torch.parallel.ring.ring_radiance`, runs one
node of every lane a round through three steps (``csrc/ring_shade.cu``):

* :func:`ring_start`: each lane's primary ray becomes its node;
* :func:`ring_shadow` (lit scenes): the live lanes' nodes shaded up to the
  lights, their shadow rays written to an ``(n_light, 7, N)`` query buffer
  (origin, direction, squared range; zeros where a node asks nothing);
* :func:`ring_finish`: the nodes shaded with the ring's answers (the hit
  ``t`` and ``hit``, the winner's row in the kernels' layout,
  :func:`raytrace_tpu_torch.render.megakernel.kernel_rows`, and one blocked
  bit per light and lane), each contribution added to its lane's sum, and
  the next node made: the live child of a linear scene, or, in a fan-out
  scene, K3's preorder (the first live child next, the others pushed in
  slot order, a pop when none is live).

Between them the ring's closest hit is the scan kernel's on each resident
shard, and each lane's row comes round with the object table's row
shards, one :func:`gather_rows` launch a ring step.  The lanes' state
(:class:`RingLanes`) lies on the device between steps.  Each wrapper
launches its kernel on CUDA tensors, or raises; on CPU tensors it runs the
plain twin, :data:`ring_shade_reference`: the same three steps on the same
state tensors in PyTorch, through
:func:`raytrace_tpu_torch.models.materials.shade` and the plain version's
hit record (:func:`raytrace_tpu_torch.ops.intersect.large_scene_rec`),
with the rows gathered by the plain selects
(:func:`raytrace_tpu_torch.parallel.ring.ring_gather_rows_reference`), so
that the twin holds every ring kernel on the card.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import torch

from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build, intersect, rng, vec
from raytrace_tpu_torch.ops.intersect import per_scene_cache
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.parallel.ring import (ring_gather_rows,
                                              ring_gather_rows_reference)
from raytrace_tpu_torch.render.megakernel import (TREE_ENTRY_BYTES,
                                                  TREE_SLAB_MAX_BYTES,
                                                  pack_header)
from raytrace_tpu_torch.scene.schema import (BG_SKYBOX, CAM_DEPTH_OF_FIELD,
                                             SceneData, SceneSpec)

KERNEL_RING = _build.KERNEL_RING
# words of a node and of a stack entry: ray 6, significance, throughput 3,
# two key words, depth (csrc/render_common.cuh, ENTRY_WORDS)
NODE_WORDS = TREE_ENTRY_BYTES // 4
# floats of a shadow query: origin 3, direction 3, squared range
QUERY = 7


class RingLanes(NamedTuple):
    """The lanes of a ring render between steps, on the lanes' device; each
    word of a lane ``N`` apart."""

    node: torch.Tensor   # (13, N) int32: the node each lane runs next
    acc: torch.Tensor    # (3, N) float32: the lane's sum
    live: torch.Tensor   # (N,) int32: 1 while the lane's walk goes on
    sp: torch.Tensor     # (N,) int32: entries on the lane's stack
    stack: torch.Tensor  # (cap * 13, N) int32 (K3's slab layout); (0, N)
                         # for a linear scene

    def rays(self) -> tuple[V3, V3]:
        """The nodes' rays, (N,) float32 views into ``node`` (a lane whose
        walk has ended has a zero direction)."""
        f = self.node[:6].view(torch.float32)
        return V3(f[0], f[1], f[2]), V3(f[3], f[4], f[5])


class RingStep(NamedTuple):
    """The steps of a ring round (:func:`ring_start`, :func:`ring_shadow`,
    :func:`ring_finish` and their signatures) and the gather of the
    winners' rows (``rows(mat_rows, obj, mesh)``, as
    :func:`raytrace_tpu_torch.parallel.ring.ring_gather_rows`)."""

    start: Callable
    shadow: Callable
    finish: Callable
    rows: Callable


def tree_m(spec: SceneSpec) -> int:
    """The most children of a node for the tree instances, 0 for a linear
    scene (``render/integrator.py::tree_loop_stack``)."""
    from raytrace_tpu_torch.render.integrator import tree_loop_stack

    return tree_loop_stack(spec)[0] if spec.children_per_ray > 1 else 0


def stack_entries(spec: SceneSpec) -> int:
    """Entries of a lane's DFS stack: the plain walk's ``1 + (max_depth +
    1)(m - 1)``, which the walk never exceeds; 0 for a linear scene."""
    from raytrace_tpu_torch.render.integrator import tree_loop_stack

    return tree_loop_stack(spec)[3] if spec.children_per_ray > 1 else 0


def max_lanes(spec: SceneSpec, budget: int) -> int:
    """Lanes of one ring launch: ``budget``, bounded so that their DFS
    stacks take at most ``TREE_SLAB_MAX_BYTES``, as K3's slab does."""
    stack = TREE_ENTRY_BYTES * stack_entries(spec)
    return (max(min(budget, TREE_SLAB_MAX_BYTES // stack), 1) if stack
            else budget)


def ring_lanes(spec: SceneSpec, n: int, device) -> RingLanes:
    """Uninitialised state for ``n`` lanes (:func:`ring_start` fills it)."""
    def words(*shape):
        return torch.empty(shape, dtype=torch.int32, device=device)

    return RingLanes(words(NODE_WORDS, n),
                     torch.empty((3, n), dtype=torch.float32, device=device),
                     words(n), words(n),
                     words(stack_entries(spec) * NODE_WORDS, n))


def _check_answers(lanes: RingLanes, t, hit, rows, blocked, n_light) -> None:
    n = lanes.live.shape[0]
    if t.dtype != torch.float32 or t.shape != (n,):
        raise ValueError("t must be (N,) float32")
    if hit.dtype != torch.bool or hit.shape != (n,):
        raise ValueError("hit must be (N,) bool")
    if rows.dtype != torch.float32 or rows.shape != (n, 24):
        raise ValueError("rows must be (N, 24) float32, the kernels' layout")
    if blocked is not None and (blocked.dtype != torch.bool
                                or blocked.shape != (n_light, n)):
        raise ValueError("blocked must be (n_light, N) bool")
    for x in (t, hit, rows, blocked):
        if x is not None and x.device != lanes.node.device:
            raise ValueError("the answers must lie on the lanes' device")


# ---- the kernels (csrc/ring_shade.cu) ----

_lib_ready: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _lib_ready
    if _lib_ready is None:
        lib = _build.load(KERNEL_RING)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.rt_ring_start.argtypes = ([p] * 4 + [i, p, i, ctypes.c_uint32]
                                      + [p] * 4 + [ctypes.c_longlong, p])
        lib.rt_ring_shadow.argtypes = ([p] + [i] * 5 + [p] * 6
                                       + [ctypes.c_longlong, p])
        lib.rt_ring_finish.argtypes = ([p] * 3 + [i] * 6 + [p] * 9
                                       + [ctypes.c_longlong, p])
        for fn in (lib.rt_ring_start, lib.rt_ring_shadow, lib.rt_ring_finish):
            fn.restype = ctypes.c_int
        lib.rt_ring_rows.argtypes = [p, i, i, p, p, ctypes.c_longlong, p]
        lib.rt_ring_rows.restype = ctypes.c_int
        lib.rt_error_string.argtypes = [i]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib_ready = lib
    return _lib_ready


def _call(fn, device, *args) -> None:
    """``fn(*args, stream)``, an entry of ``csrc/ring_shade.cu`` whose
    last argument before the stream is its lane count; nothing is launched
    for no lane."""
    if args[-1] == 0:
        return
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           f"{_lib().rt_error_string(rc).decode()}")
    _build.LAUNCHES[KERNEL_RING] += 1
    _build.LAUNCHES[fn.__name__.removeprefix("rt_")] += 1


def _cuda(device) -> None:
    if device.type != "cuda":
        raise ValueError(f"no ring kernel for device {device}")


# the last header buffer packed, reused while the scene is unchanged
_header_buffer = per_scene_cache(pack_header)


def _flags(spec: SceneSpec) -> list[int]:
    return [spec.n_lights, spec.max_depth, int(spec.has_reflect),
            int(spec.has_refract), spec.n_indirect]


def start_ids(pix, piy, aa, cam) -> tuple[list[torch.Tensor], int]:
    """The identity tensors as :func:`ring_start`'s kernel reads them, and
    their width in bytes: four contiguous int32 tensors as they come, or
    else each as int64 (a copy of each tensor that is not a contiguous
    int64 one already).  The kernel keeps each id's low 32 bits, as the
    plain version's words do (:func:`raytrace_tpu_torch.ops.rng.as_words`)."""
    ids = (pix, piy, aa, cam)
    if all(t.dtype == torch.int32 for t in ids):
        return [t.contiguous() for t in ids], 4
    return [t.to(torch.int64).contiguous() for t in ids], 8


def ring_start(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
               seed: int) -> RingLanes:
    """The lanes' state with each lane's primary ray as its node, from
    (N,) integer identity tensors (pixel x, pixel y, antialias sample,
    lens sample).  On CUDA tensors of int32 or int64 ids the kernel is its
    one launch."""
    device = pix.device
    if device.type == "cpu":
        return start_reference(data, spec, pix, piy, aa, cam, seed)
    _cuda(device)
    n = pix.shape[0]
    lanes = ring_lanes(spec, n, device)
    ids, width = start_ids(pix, piy, aa, cam)
    _call(_lib().rt_ring_start, device, *(t.data_ptr() for t in ids), width,
          _header_buffer(data, spec).data_ptr(),
          int(spec.cam_type == CAM_DEPTH_OF_FIELD), int(seed) & rng.MASK,
          lanes.node.data_ptr(), lanes.acc.data_ptr(), lanes.live.data_ptr(),
          lanes.sp.data_ptr(), n)
    return lanes


def ring_shadow(data: SceneData, spec: SceneSpec, lanes: RingLanes, t, hit,
                rows) -> torch.Tensor:
    """The shadow rays of the live lanes' nodes, given the ring's closest
    hit of each (``t`` (N,) float32, ``hit`` (N,) bool, ``rows`` (N, 24)
    float32 the winner's row): ``(n_light, 7, N)`` float32, per light the
    origin, direction and squared range, zeros where a node asks nothing
    of the light (dead, missed, past max_depth, or both gates shut)."""
    device = lanes.node.device
    if device.type == "cpu":
        return shadow_reference(data, spec, lanes, t, hit, rows)
    _cuda(device)
    _check_answers(lanes, t, hit, rows, None, spec.n_lights)
    n = lanes.live.shape[0]
    q = torch.empty((spec.n_lights, QUERY, n), dtype=torch.float32,
                    device=device)
    _call(_lib().rt_ring_shadow, device,
          _header_buffer(data, spec).data_ptr(), *_flags(spec),
          lanes.node.data_ptr(), lanes.live.data_ptr(),
          t.contiguous().data_ptr(), hit.contiguous().data_ptr(),
          rows.contiguous().data_ptr(), q.data_ptr(), n)
    return q


def ring_finish(data: SceneData, spec: SceneSpec, lanes: RingLanes, t, hit,
                rows, blocked) -> None:
    """One round's shading of the live lanes, in place: each node's
    contribution added to its lane's sum, its next node made, ``live``
    cleared where the walk ended.  The answers as :func:`ring_shadow`
    takes them, and ``blocked`` (n_light, N) bool, whether each light's
    shadow ray of each node is blocked (None where no node of the round
    asks: a linear scene's last round, or a scene without lights)."""
    device = lanes.node.device
    if device.type == "cpu":
        return finish_reference(data, spec, lanes, t, hit, rows, blocked)
    _cuda(device)
    _check_answers(lanes, t, hit, rows, blocked, spec.n_lights)
    if spec.bg_type == BG_SKYBOX:
        quads, face_hw = backgrounds.sky_buffer(data.bg_cube, spec)
        sky = [quads.data_ptr(), face_hw]
    else:
        sky = [None, None]
    _call(_lib().rt_ring_finish, device,
          _header_buffer(data, spec).data_ptr(), *sky, *_flags(spec),
          tree_m(spec), lanes.node.data_ptr(), lanes.acc.data_ptr(),
          lanes.live.data_ptr(), lanes.sp.data_ptr(),
          lanes.stack.data_ptr() if lanes.stack.numel() else None,
          t.contiguous().data_ptr(), hit.contiguous().data_ptr(),
          rows.contiguous().data_ptr(),
          None if blocked is None else blocked.contiguous().data_ptr(),
          lanes.live.shape[0])


def gather_rows(shard, first: int, obj, out) -> None:
    """One step of the rows' ring on CUDA tensors, in place: each lane
    whose winner ``obj`` ((N,) int32) lies in the resident row shard
    ``shard`` ((per, 24) float32, the rows of object ids ``[first, first +
    per)``) takes its row into ``out`` ((N, 24) float32); the others keep
    theirs.  Its plain version is the select of
    :func:`raytrace_tpu_torch.parallel.ring.ring_gather_rows_reference`."""
    device = obj.device
    _cuda(device)
    if (shard.dtype != torch.float32 or shard.ndim != 2
            or shard.shape[1] != 24 or out.dtype != torch.float32
            or out.shape != (obj.shape[0], 24) or obj.dtype != torch.int32):
        raise ValueError("the rows' ring takes (per, 24) and (N, 24) float32 "
                         "rows and (N,) int32 ids")
    shard = shard.detach().contiguous()
    if shard.data_ptr() % 16 or out.data_ptr() % 16 or not out.is_contiguous():
        raise ValueError("the rows must be contiguous and 16-byte aligned")
    _call(_lib().rt_ring_rows, device, shard.data_ptr(), first,
          shard.shape[0], obj.contiguous().data_ptr(), out.data_ptr(),
          obj.shape[0])


ring_shade_kernels = RingStep(ring_start, ring_shadow, ring_finish,
                              ring_gather_rows)


# ---- the plain twin ----

def _node_words(ro: V3, rd: V3, sig, tp: V3, k1, k2, depth) -> torch.Tensor:
    """(13, N) int32 node words, as the kernels store a Node and its
    depth (floats by their bits, keys as 32-bit words)."""
    f = torch.stack([ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, sig, tp.x, tp.y,
                     tp.z]).to(torch.float32).view(torch.int32)
    k = torch.stack([k1.to(torch.int64), k2.to(torch.int64),
                     depth.to(torch.int64)]) & rng.MASK
    return torch.cat([f, k.to(torch.int32)])


def _node_of(words: torch.Tensor):
    """``(ro, rd, sig, tp, k1, k2, depth)`` of (13, ...) node words: keys
    as the plain RNG's int64 words, depth int64."""
    f = words[:10].view(torch.float32)
    k = words[10:].to(torch.int64) & rng.MASK
    return (V3(f[0], f[1], f[2]), V3(f[3], f[4], f[5]), f[6],
            V3(f[7], f[8], f[9]), k[0], k[1], k[2])


def start_reference(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                    seed: int) -> RingLanes:
    """The plain :func:`ring_start`."""
    from raytrace_tpu_torch.render.integrator import primary_rays

    ro, rd, k1, k2 = primary_rays(data, spec, pix, piy, aa, cam, seed)
    lanes = ring_lanes(spec, pix.shape[0], pix.device)
    one = torch.ones_like(ro.x)
    lanes.node.copy_(_node_words(ro, rd, one, V3(one, one, one), k1, k2,
                                 torch.zeros_like(k1)))
    lanes.acc.zero_()
    lanes.live.fill_(1)
    lanes.sp.zero_()
    return lanes


def _shade(data: SceneData, spec: SceneSpec, lanes: RingLanes, t, hit, rows,
           occluded):
    """The nodes shaded with the ring's hit: ``(node, live, deep, hit
    record, emit, children)``.  One call of ``shade`` serves every depth:
    a node past max_depth takes the ambient term alone and no children
    (and when every live node is past it, ``shade`` is asked for that
    alone)."""
    from raytrace_tpu_torch.models.materials import shade

    ro, rd, sig, tp, k1, k2, depth = node = _node_of(lanes.node)
    live = lanes.live != 0
    deep = depth > spec.max_depth
    rec = intersect.large_scene_rec(rows, t, torch.zeros_like(depth), hit,
                                    ro, rd)
    shallow = live & ~deep
    emit, children = shade(data, spec, ro, rd, rec, sig, shallow, k1, k2,
                           0 if bool(shallow.any()) else spec.max_depth + 1,
                           occluded=occluded)
    return node, live, deep, rec, vec.where(deep, rec.ambient, emit), children


def shadow_reference(data: SceneData, spec: SceneSpec, lanes: RingLanes, t,
                     hit, rows) -> torch.Tensor:
    """The plain :func:`ring_shadow`."""
    q = torch.zeros((spec.n_lights, QUERY, lanes.live.shape[0]),
                    dtype=torch.float32, device=lanes.node.device)

    def record(li, origin, ldir, sq, has_range, need):
        for j, x in enumerate((*origin, *ldir, sq)):
            q[li, j] = torch.where(need, x, 0.0)
        return torch.zeros_like(need)

    _shade(data, spec, lanes, t, hit, rows, record)
    return q


def _background(data: SceneData, spec: SceneSpec, rd: V3) -> V3:
    """The plain background of miss rays: the solid color, or the plain
    skybox lookup (``_skybox``, on any device)."""
    if spec.bg_type != BG_SKYBOX:
        return backgrounds.background_color_v(data, spec, rd)
    out = backgrounds._skybox(data.bg_cube, spec, torch.stack(list(rd), -1))
    return V3(out[..., 0], out[..., 1], out[..., 2])


def finish_reference(data: SceneData, spec: SceneSpec, lanes: RingLanes, t,
                     hit, rows, blocked) -> None:
    """The plain :func:`ring_finish`: the same state tensors, in place."""
    def bits(li, origin, ldir, sq, has_range, need):
        return (blocked[li] if blocked is not None
                else torch.zeros_like(need))

    (ro, rd, sig, tp, k1, k2, depth), live, deep, rec, emit, children = \
        _shade(data, spec, lanes, t, hit, rows, bits)
    local = vec.where(rec.hit, emit, _background(data, spec, rd))
    add = tp.mul(local)
    for j, c in enumerate(add):
        lanes.acc[j] = torch.where(live, lanes.acc[j] + c, lanes.acc[j])
    m, n = tree_m(spec), live.shape[0]
    words = (torch.stack([_node_words(c.ro, c.rd, c.sig, tp.mul(c.weight),
                                      *rng.derive(k1, k2, c.slot), depth + 1)
                          for c in children]) if children
             else lanes.node.new_empty((0, NODE_WORDS, n)))
    take = (torch.stack([live & c.live for c in children]) if children
            else live.new_zeros((0, n)))
    if m > 0:
        walking, nxt = _dfs_reference(lanes, words, take, m)
    elif children:
        walking, nxt = take[0], words[0]
    else:
        walking, nxt = torch.zeros_like(live), lanes.node
    # a lane whose walk ended keeps its node with a zero direction
    ended = lanes.node.clone()
    ended[3:6] = 0
    lanes.node.copy_(torch.where(walking, nxt, ended))
    lanes.live.copy_(walking.to(torch.int32))


def _dfs_reference(lanes: RingLanes, words, take, m: int):
    """K3's step of the walk on every live lane (``dfs_node``), given each
    child slot's node words ``words`` (b, 13, N) and whether the slot is
    live ``take`` (b, N): the first live child is the next node, the
    others are pushed in slot order and turned round, so that the child
    of rank r (r >= 1) lands at ``sp + taken - 1 - r``; with none, the top
    entry pops.  A node's b slots go to at most m children, the first m
    live ones when b > m.  Updates ``sp`` and the stack in place; returns
    ``(walking, next node words)``."""
    n = take.shape[1]
    stack = lanes.stack.view(-1, NODE_WORDS, n)
    sp0 = lanes.sp.to(torch.int64)
    rank = torch.cumsum(take.to(torch.int64), dim=0) - take.to(torch.int64)
    if take.shape[0] > m:
        take = take & (rank < m)
    total = take.sum(dim=0)
    lane_ids = torch.arange(n, device=take.device)
    nxt = lanes.node.clone()
    if take.shape[0]:
        first = (take & (rank == 0)).to(torch.int64).argmax(dim=0)
        nxt = torch.where(total > 0, words[first, :, lane_ids].T, nxt)
        slot, idx = torch.nonzero(take & (rank > 0), as_tuple=True)
        stack[(sp0 + total - 1 - rank)[slot, idx], :, idx] = \
            words[slot, :, idx]
    pop = (lanes.live != 0) & (total == 0) & (sp0 > 0)
    idx = lane_ids[pop]
    nxt[:, idx] = stack[sp0[pop] - 1, :, idx].T
    sp = torch.where(total > 0, sp0 + total - 1,
                     torch.where(pop, sp0 - 1, sp0))
    lanes.sp.copy_(sp.to(torch.int32))
    return (total > 0) | pop, nxt


ring_shade_reference = RingStep(start_reference, shadow_reference,
                                finish_reference, ring_gather_rows_reference)
