"""Radiance integrators and the image loop (raytrace.rs:261-276,
main.rs:39-59).

PyTorch counterpart of :mod:`raytrace_tpu.render.integrator`.  A linear
scene's path is a chain of ``max_depth + 2`` closest-hit + shade rounds
(depths 0..max_depth shade fully and spawn, depth max_depth+1 is
ambient/background only), with per-lane throughput and liveness masks:
:func:`radiance_linear_v`.  A fan-out scene's paths form a tree per
lane, walked depth first: :func:`radiance_tree_loop_v`.  They are the
plain PyTorch versions of the two CUDA kernels behind
:mod:`raytrace_tpu_torch.render.megakernel`, and the CPU path.

The image loop (:func:`_image_loop`) is the one loop of every render
path: the whole image on one device, its pixels sharded over a mesh's
ranks, or one rank's band of rows.  It sums the launch groups into a
float64 image on the scene's device and fetches it once a render, keeping
one group queued on the device ahead of the one it waits for; it
checkpoints that sum after every launch group where asked, and refuses to
resume a checkpoint written for another render config.
"""

from __future__ import annotations

import os
import sys
import time
import zipfile

import numpy as np
import torch

from raytrace_tpu_torch.models.backgrounds import background_color_v
from raytrace_tpu_torch.models.cameras import project
from raytrace_tpu_torch.models.materials import shade
from raytrace_tpu_torch.ops import rng, vec
from raytrace_tpu_torch.ops.intersect import closest_hit
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.parallel import mesh as meshlib
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene.schema import Scene, SceneData, SceneSpec
from raytrace_tpu_torch.utils.profiling import (ACCUMULATE, CHECKPOINT, FETCH,
                                                IMAGE_LOOP, ISSUE, PROGRESS,
                                                RAYGEN, WAIT, annotate, span)


def radiance_linear_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
                      k1, k2, significance=None) -> V3:
    """Radiance of chains that never fan out (``children_per_ray <= 1``:
    one indirect slot, or the reflect slot of pure mirror-Phong scenes),
    with per-lane significance (initially ``significance``, default 1,
    main.rs:54) and throughput.  Elementwise over whatever lane shape
    ``ro.x`` has."""
    if spec.children_per_ray > 1:
        raise ValueError("fan-out scenes take radiance_tree_loop_v")
    sig = _initial_significance(ro.x, significance)
    live = torch.ones(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    tp = vec.full_like(sig, 1.0)
    acc = vec.full_like(sig, 0.0)
    zero = vec.full_like(sig, 0.0)

    for depth in range(spec.max_depth + 2):
        hit = closest_hit(data, spec, ro, rd)
        emit, children = shade(data, spec, ro, rd, hit, sig, live, k1, k2,
                               depth)
        bg = background_color_v(data, spec, rd)
        local = vec.where(hit.hit, emit, bg)
        acc = acc + vec.where(live, tp.mul(local), zero)
        if not children:
            break
        c = children[0]
        ro, rd, sig, live = c.ro, c.rd, c.sig, c.live
        tp = vec.where(live, tp.mul(c.weight), zero)
        k1, k2 = rng.derive(k1, k2, c.slot)
    return acc


def _route_children(children, m: int, tp: V3, k1, k2):
    """b child slots -> m virtual children, routed per lane.

    The child gates are material-exclusive (``SceneSpec.max_live_children``),
    so at most m of a lane's b slots are live; the j-th live slot goes to
    virtual child j, by an exclusive running count of live slots.  RNG
    keys are derived from the ORIGINAL slot index before routing, so
    every child keeps its stream identity.  Returns m tuples
    ``(ro, rd, sig, tp, live, k1, k2)``, ``tp`` already multiplied by the
    child's weight; a virtual child no slot went to is all zeros."""
    b = len(children)
    keys = [rng.derive(k1, k2, c.slot) for c in children]
    tps = [tp.mul(c.weight) for c in children]

    run = torch.zeros(children[0].live.shape, dtype=torch.int64,
                      device=children[0].live.device)
    prefix = []
    for c in children:
        prefix.append(run)
        run = run + c.live.to(torch.int64)

    virt = []
    for j in range(m):
        take = [children[s].live & (prefix[s] == j) for s in range(b)]

        def sel(getter):
            out = torch.zeros_like(getter(0))
            for s in range(1, b):
                out = torch.where(take[s], getter(s), out)
            return torch.where(take[0], getter(0), out)

        def selv(getter):
            return V3(sel(lambda s: getter(s).x), sel(lambda s: getter(s).y),
                      sel(lambda s: getter(s).z))

        live = take[0]
        for s in range(1, b):
            live = live | take[s]
        virt.append((selv(lambda s: children[s].ro),
                     selv(lambda s: children[s].rd),
                     sel(lambda s: children[s].sig),
                     selv(lambda s: tps[s]),
                     live,
                     sel(lambda s: keys[s][0]),
                     sel(lambda s: keys[s][1])))
    return virt


def tree_nodes(spec: SceneSpec) -> int:
    """Closest-hit rounds per lane of the DFS (its node count):
    ``sum_{d=0}^{max_depth+1} m^d``."""
    return tree_loop_stack(spec)[2]


def _dfs_schedule(m: int, levels: int) -> list[int]:
    """Preorder schedule of the uniform m-ary virtual-child tree: the
    depth of each visit.  The tree's shape is the same for every lane
    (liveness is masked, never structural), so the stack pointer and each
    visit's depth are known before the walk; the peak stack is
    :func:`tree_loop_stack`'s."""
    depths = []

    def walk(d):
        depths.append(d)
        if d + 1 < levels:
            for _ in range(m):
                walk(d + 1)

    walk(0)
    return depths


def tree_loop_stack(spec: SceneSpec):
    """(m, levels, node count, stack capacity) of the DFS, in closed
    form: a uniform m-ary preorder pops 1 and pushes m at each interior
    node, so the peak along the leftmost spine is
    ``1 + (levels - 1) * (m - 1)``; the node count is the geometric sum."""
    m = max(min(spec.max_live_children, spec.children_per_ray), 1)
    levels = spec.max_depth + 2
    n_nodes = levels if m == 1 else (m ** levels - 1) // (m - 1)
    cap = 1 + (levels - 1) * (m - 1)
    return m, levels, n_nodes, cap


def tree_loop_entry(ro: V3, rd: V3, sig, tp: V3, live01, k1, k2, dtype):
    """One DFS stack entry as a 13-component tuple: rox..z, rdx..z, sig,
    tpx..z, live (0/1 in the compute dtype), k1, k2."""
    return (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z, sig, tp.x, tp.y, tp.z,
            live01.to(dtype), k1, k2)


def tree_loop_node(data: SceneData, spec: SceneSpec, m: int, entry,
                   depth: int):
    """One DFS node visit: closest hit, shade, route the child slots to m
    virtual children.  ``entry`` is a popped 13-tuple
    (:func:`tree_loop_entry`).  Returns ``(contrib: V3, virt)``, where
    ``virt`` holds the packed child entries (none at a leaf; a dead child
    has live = 0 and zero throughput)."""
    dtype = entry[0].dtype
    ro = V3(entry[0], entry[1], entry[2])
    rd = V3(entry[3], entry[4], entry[5])
    sig = entry[6]
    tp = V3(entry[7], entry[8], entry[9])
    live = entry[10] > 0.5
    k1, k2 = entry[11], entry[12]

    hit = closest_hit(data, spec, ro, rd)
    emit, children = shade(data, spec, ro, rd, hit, sig, live, k1, k2, depth)
    bg = background_color_v(data, spec, rd)
    local = vec.where(hit.hit, emit, bg)
    zero = vec.full_like(sig, 0.0)
    contrib = vec.where(live, tp.mul(local), zero)

    if len(children) > m:
        virt = _route_children(children, m, tp, k1, k2)
    else:
        virt = [(c.ro, c.rd, c.sig, tp.mul(c.weight), c.live)
                + rng.derive(k1, k2, c.slot) for c in children]
    packed = []
    for cro, crd, csig, ctp, clive, ck1, ck2 in virt:
        ctp = vec.where(clive, ctp, zero)
        packed.append(tree_loop_entry(cro, crd, csig, ctp,
                                      torch.where(clive, 1.0, 0.0), ck1, ck2,
                                      dtype))
    return contrib, packed


def radiance_tree_loop_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
                         k1, k2, significance=None) -> V3:
    """Radiance of fan-out scenes as a depth-first walk of each lane's
    virtual child tree (the recursion of ``ray_color``,
    raytrace.rs:261-267), the plain version of the CUDA tree kernel.

    Each node does one closest hit and one shade on the same lane shape
    and routes its b child slots to ``m`` virtual children
    (:func:`tree_loop_node`).  The walk is a preorder visit over the
    static schedule (:func:`_dfs_schedule`) with one running sum; pending
    siblings wait on an explicit stack of entries, child j pushed at
    ``sp + (m-1-j)`` so that the children pop in order.  Since the tree's
    shape is the same for every lane, the stack pointer and each visit's
    depth are Python ints.  Every node is visited for every lane; a dead
    entry contributes exactly zero.  ``significance`` is the primary
    rays' (default 1)."""
    dtype = ro.x.dtype
    m, levels, _, cap = tree_loop_stack(spec)
    depths = _dfs_schedule(m, levels)
    one = torch.ones_like(ro.x)
    stack = [None] * cap
    stack[0] = tree_loop_entry(ro, rd, _initial_significance(ro.x,
                                                             significance),
                               V3(one, one, one), one, k1, k2, dtype)
    acc = vec.full_like(ro.x, 0.0)
    sp = 1
    for depth in depths:
        sp -= 1
        contrib, virt = tree_loop_node(data, spec, m, stack[sp], depth)
        acc = acc + contrib
        if depth < levels - 1:
            # child j lands at sp + (m-1-j): popped in preorder
            for j, entry in enumerate(virt):
                stack[sp + (m - 1 - j)] = entry
            sp += m
    return acc


def _initial_significance(like, significance):
    return (torch.ones_like(like) if significance is None
            else torch.broadcast_to(torch.as_tensor(
                significance, dtype=like.dtype, device=like.device),
                like.shape))


def radiance(data: SceneData, spec: SceneSpec, ro, rd, k1, k2,
             significance=None) -> torch.Tensor:
    """Radiance of (N, 3) primary rays ``ro``, ``rd`` with their (N,) RNG
    streams, as an (N, 3) tensor: the linear chain or the DFS, as the
    scene's fan-out asks (``ray_color``, raytrace.rs:261-267)."""
    fn = (radiance_linear_v if spec.children_per_ray <= 1
          else radiance_tree_loop_v)
    return vec.pack(fn(data, spec, vec.splat(ro), vec.splat(rd), k1, k2,
                       significance))


@annotate(RAYGEN)
def primary_rays(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                 seed: int):
    """Jittered primary rays for per-lane (pixel-x, pixel-y, aa-sample,
    lens-sample) integer identities: the NDC transform of main.rs:39-53
    plus the camera projection.  Returns ``(ro, rd, k1, k2)`` where k1/k2
    are the per-lane RNG streams (lens index folded in)."""
    dtype = data.dtype
    pix, piy, aa, cam = (rng.as_words(w) for w in (pix, piy, aa, cam))

    # jitter streams keyed by (x, y, aa) only: shared across lens samples
    jk1, jk2 = rng.make_keys(seed, pix, piy, aa)
    u = rng.draw(jk1, jk2, rng.PURPOSE_AA_X, dtype)
    v = rng.draw(jk1, jk2, rng.PURPOSE_AA_Y, dtype)

    # unit square inscribed in the image (main.rs:39-53)
    halfw = spec.width / 2.0
    halfh = spec.height / 2.0
    scale = max(1.0 / halfw, 1.0 / halfh)
    pos_x = ((rng.to_float(pix, dtype) + u) - halfw) * scale
    pos_y = ((rng.to_float(piy, dtype) + v) - halfh) * scale

    k1, k2 = rng.make_keys(seed, pix, piy, aa, cam)
    ro, rd = project(data, spec, pos_x, pos_y, k1, k2)
    return ro, rd, k1, k2


def sample_pixels(data: SceneData, spec: SceneSpec, px, py, sample_ids,
                  seed: int, radiance=None) -> torch.Tensor:
    """Mean radiance of samples ``sample_ids`` (S,) for pixels (px, py)
    (P,) each, as a (P, 3) tensor (main.rs:45-55 x raytrace.rs:270-276).
    y counts from the bottom row.  Every lane goes through ``radiance``, by
    default :func:`raytrace_tpu_torch.render.megakernel.radiance_lanes`:
    on CUDA tensors a kernel, for every float32 scene whatever its DFS
    stack (a float64 scene raises there, naming its ROADMAP item), on CPU
    tensors the kernels' plain version, for every scene.  The default
    takes the launch's lanes in factored form (``megakernel.LaunchLanes``:
    a kernel decodes them, where it runs); a ``radiance`` given takes the
    four tensors of :func:`lane_ids`.  The benchmark passes
    ``megakernel.radiance_lanes_split`` to time a large scene's split path,
    and ``megakernel.radiance_lanes_reference`` to hold the kernels to
    their plain version."""
    if radiance is None:
        rad = megakernel.radiance_lanes(data, spec, megakernel.LaunchLanes(
            px, py, sample_ids, spec.cam_samples), seed)
    else:
        rad = radiance(data, spec,
                       *lane_ids(px, py, sample_ids, spec.cam_samples), seed)
    # each channel's samples of a pixel are contiguous: one mean for the
    # three channels
    return torch.stack(tuple(rad)).reshape(3, px.shape[0], -1).mean(
        dim=2).T.contiguous()


def lane_ids(px, py, sample_ids, cam_samples: int):
    """The (pixel x, pixel y, aa sample, lens sample) identities of one
    launch of :func:`sample_pixels`: the lane axis is (pixel, aa sample,
    lens sample), flattened.  The four are rows of one broadcast copy, in
    the inputs' common dtype: two launches on the card, where each launch
    costs the host more than the copy costs the device."""
    cam = torch.arange(cam_samples, dtype=px.dtype, device=px.device)
    ids = torch.stack(torch.broadcast_tensors(
        px[:, None, None], py[:, None, None], sample_ids[None, :, None],
        cam[None, None, :]))
    return ids.reshape(4, -1).unbind(0)


def id_dtype(top: int) -> torch.dtype:
    """The dtype of integer ids below ``top``: int32 where they fit, as
    every pixel and sample id of a render does, else int64.  Both give the
    same 32-bit words (``rng.as_words``, the kernels' ``uint32_t``)."""
    return torch.int32 if top <= 1 << 31 else torch.int64


def _render_chunks(data: SceneData, spec: SceneSpec, px, py, s0: int,
                   s_launch: int, n_chunks: int, seed: int,
                   p_launch: int) -> torch.Tensor:
    """``n_chunks`` sample chunks of ``s_launch`` samples from ``s0`` on,
    over all pixels in tiles of ``p_launch``, averaged on the device."""
    n = px.shape[0]
    out = torch.empty((n, 3), dtype=data.dtype, device=px.device)
    for off in range(0, n, p_launch):
        pxt, pyt = px[off:off + p_launch], py[off:off + p_launch]
        tile = torch.zeros((pxt.shape[0], 3), dtype=data.dtype,
                           device=px.device)
        for i in range(n_chunks):
            top = s0 + (i + 1) * s_launch
            sids = torch.arange(top - s_launch, top, dtype=id_dtype(top),
                                device=px.device)
            tile = tile + sample_pixels(data, spec, pxt, pyt, sids, seed)
        out[off:off + p_launch] = tile / n_chunks
    return out


def _render_group(mesh, data: SceneData, spec: SceneSpec, px, py, s0: int,
                  s_launch: int, n_chunks: int, seed: int,
                  p_launch: int) -> torch.Tensor:
    """One launch group of :func:`_render_chunks`; with a ``mesh``, the
    pixels sharded over its ranks: each rank renders a contiguous shard,
    their count padded to a multiple of the ranks (pad pixels render
    pixel 0), and gets every rank's shard back in rank order, trimmed.
    ``p_launch`` is the tile of all ranks together."""
    if mesh is None:
        return _render_chunks(data, spec, px, py, s0, s_launch, n_chunks,
                              seed, p_launch)
    n, k = px.shape[0], mesh.ranks
    pad = (-n) % k
    px, py = (torch.cat([t, t.new_zeros(pad)]) for t in (px, py))
    lo, hi = mesh.rank * (n + pad) // k, (mesh.rank + 1) * (n + pad) // k
    out = _render_chunks(data, spec, px[lo:hi], py[lo:hi], s0, s_launch,
                         n_chunks, seed, max(p_launch // k, 1))
    return torch.cat(meshlib.all_gather(out, mesh))[:n]


def _s_p_launch(spec: SceneSpec, aa: int, max_lanes: int):
    """(samples, pixels) per launch: fill the lane budget without
    exceeding it, taking more samples per launch for small images (a
    primary sample takes one lane)."""
    lane_budget = max(max_lanes // spec.cam_samples, 1)
    n_pix = spec.width * spec.height
    if n_pix <= lane_budget:
        return min(aa, max(lane_budget // n_pix, 1)), n_pix
    return 1, lane_budget


def _wavefront_widest(spec: SceneSpec) -> int:
    """Widest wavefront level of the JAX package's lane-compacted
    wavefront, in lanes per primary sample: each level expands to b
    slots, then compaction shrinks it to m live lanes."""
    b = max(spec.children_per_ray, 1)
    m = max(spec.max_live_children, 1)
    if m >= b:
        return b ** (spec.max_depth + 1)
    return b * m ** spec.max_depth


# sample chunks in one launch group at most
CHUNK_GROUP = 32


def _group_cap(spec: SceneSpec, s_launch: int) -> int:
    """Sample chunks per launch group: :data:`CHUNK_GROUP`, bounded by a
    work budget so that one group never runs for minutes: fan-out scenes
    do up to :func:`_wavefront_widest` times the work per lane of a linear
    chain, so they take smaller groups."""
    work_per_chunk = (spec.width * spec.height * s_launch * spec.cam_samples
                      * _wavefront_widest(spec))
    return max(min(CHUNK_GROUP, (1 << 28) // max(work_per_chunk, 1)), 1)


# deterministic failures a retry cannot fix (an OOM retry thrashes the
# allocator; a sticky CUDA error has already poisoned the context)
_PERMANENT_TYPES = (NotImplementedError, torch.OutOfMemoryError)
_PERMANENT_MARKERS = ("out of memory", "illegal memory access",
                      "illegal instruction", "misaligned address",
                      "device-side assert", "invalid argument",
                      "no kernel image", "launch failed",
                      "kernel build failed")


def _is_transient(err: BaseException) -> bool:
    """Whether a runtime error is plausibly transient."""
    if isinstance(err, _PERMANENT_TYPES):
        return False
    msg = str(err)
    return not any(m in msg for m in _PERMANENT_MARKERS)


def _retry_launch(fn, *args, retries: int = 2, wait: bool = True):
    """Run a render launch, retrying transient runtime failures.  A
    launch is a pure function of (scene, pixel/sample identities), so a
    re-issue is safe.  The result stays on its device; with ``wait`` its
    work is waited for inside the guarded region (the profiler span
    ``issue``), so asynchronous device failures surface here, else they
    surface where the caller waits (:func:`_lookahead`)."""
    for attempt in range(retries + 1):
        try:
            with span(ISSUE):
                out = fn(*args)
                if wait and out.device.type == "cuda":
                    torch.cuda.current_stream(out.device).synchronize()
            return out
        except RuntimeError as e:
            if attempt == retries or not _is_transient(e):
                raise
            print(f"[raytrace_tpu_torch] launch failed (attempt "
                  f"{attempt + 1}/{retries + 1}); retrying", file=sys.stderr)
            time.sleep(0.5 * (attempt + 1))


def _mark(out: torch.Tensor):
    """An event recorded on ``out``'s stream after the work queued so far,
    or None on the CPU, where that work is done."""
    if out.device.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(out.device))
    return done


def _wait(done) -> None:
    """Block the host until the work before the event ``done`` (from
    :func:`_mark`) has finished; at once where it is None."""
    if done is not None:
        done.synchronize()


def _lookahead(n: int, issue, finish) -> int:
    """Groups ``0..n-1`` with one queued ahead: group k+1 is issued
    (``issue(k)`` returns the group's result without waiting for it)
    before the host waits for group k (the span ``wait``, counting in
    ``ahead`` the groups queued behind it), then ``finish(k, out)`` adds
    group k in.  Returns ``n``, or the group to go on from in order after
    a transient failure at a wait: the groups in flight are dropped, and
    nothing from that group on has been added.  A permanent failure
    raises."""
    def queue(k):
        out = issue(k)
        return out, _mark(out)

    out, done = queue(0)
    for k in range(n):
        nxt = queue(k + 1) if k + 1 < n else None
        try:
            with span(WAIT, ahead=int(nxt is not None)):
                _wait(done)
        except RuntimeError as e:
            if not _is_transient(e):
                raise
            print(f"[raytrace_tpu_torch] launch group {k} failed; redoing "
                  f"it in order", file=sys.stderr)
            time.sleep(0.5)
            return k
        finish(k, out)
        if nxt is not None:
            out, done = nxt
    return n


def _accumulate(acc: torch.Tensor, out: torch.Tensor, weight: float):
    """``acc += out * weight`` in float64 on ``acc``'s device (the span
    ``accumulate``): widened, multiplied and added as three rounded
    operations, the order and the bits of numpy's ``astype``, ``*`` and
    ``+=``.  ``out * weight`` before the widening would round in float32,
    and ``add_(out, alpha=weight)`` may contract into one FMA."""
    with span(ACCUMULATE):
        acc += out.to(torch.float64) * weight


def _fetch(acc: torch.Tensor) -> np.ndarray:
    """``acc`` on the host (the span ``fetch`` with its ``bytes``): a
    copy into page-locked memory from torch's caching host allocator,
    which repeated renders reuse, where ``acc`` lives on a card; the
    tensor's own memory on the CPU."""
    with span(FETCH, bytes=acc.numel() * acc.element_size()):
        if acc.device.type == "cpu":
            return acc.numpy()
        host = torch.empty(acc.shape, dtype=acc.dtype, pin_memory=True)
        return host.copy_(acc).numpy()


def _save_checkpoint(path: str, **arrays) -> None:
    """Atomic checkpoint write: temp file + ``os.replace``, so a kill
    mid-write never corrupts the resume state."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz when the name has no extension
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def sample_groups(spec: SceneSpec, aa: int, s_launch: int, s_done: int = 0):
    """The image loop's launch groups from sample ``s_done`` on:
    ``(s0, s_launch, n_chunks)``, each ``n_chunks`` chunks of ``s_launch``
    samples, the last one ragged."""
    g_cap = _group_cap(spec, s_launch)
    s0 = s_done
    while s0 < aa:
        rem = aa - s0
        if rem >= s_launch:
            g, sl = min(g_cap, rem // s_launch), s_launch
        else:
            g, sl = 1, rem          # ragged tail chunk
        yield s0, sl, g
        s0 += g * sl


def _resume_state(path: str | None, w: int, h: int, aa: int, seed: int,
                  device: torch.device, mesh=None):
    """``(image (h*w, 3) float64 on device, s_done)`` to start the image
    loop from: the checkpoint at ``path`` when there is one, else zeros
    and 0.  With a ``mesh`` of several ranks, rank 0 alone reads the file
    and broadcasts what it found, so that the ranks need not share a
    filesystem and all resume at one sample; a file written for another
    config raises the same ``ValueError`` on every rank."""
    image, status, s_done, err = None, _CK_NONE, 0, None
    if path is not None and (mesh is None or mesh.rank == 0) \
            and os.path.exists(path):
        try:
            with np.load(path) as ck:
                if (ck["width"] == w and ck["height"] == h
                        and ck["aa"] == aa and ck["seed"] == seed):
                    status, image, s_done = (
                        _CK_RESUME, torch.from_numpy(ck["image"]),
                        int(ck["s_done"]))
                else:
                    status = _CK_MISMATCH
        except (OSError, ValueError, EOFError, KeyError,
                zipfile.BadZipFile) as e:
            # raised below, once the other ranks know not to wait
            status, err = _CK_UNREADABLE, e
    if path is not None and mesh is not None and mesh.ranks > 1:
        cdev = meshlib.collective_device(mesh)
        head = meshlib.broadcast_(torch.tensor(
            [status, s_done], dtype=torch.int64, device=cdev), mesh)
        status, s_done = (int(x) for x in head.tolist())
        if status == _CK_RESUME:
            if image is None:       # a rank that did not read the file
                image = torch.empty((h * w, 3), dtype=torch.float64)
            image = meshlib.broadcast_(image.to(cdev), mesh)
    if status == _CK_MISMATCH:
        raise ValueError(f"checkpoint {path} was written for a different "
                         f"render config; refusing to mix")
    if status == _CK_UNREADABLE:
        raise err or RuntimeError(f"rank 0 could not read checkpoint {path}")
    if status != _CK_RESUME:
        return torch.zeros((h * w, 3), dtype=torch.float64,
                           device=device), 0
    return image.to(device), s_done


# what rank 0 found at the checkpoint's path
_CK_NONE, _CK_RESUME, _CK_MISMATCH, _CK_UNREADABLE = 0, 1, 2, 3


def _image_loop(scene: Scene, *, seed: int, spp: int | None,
                max_lanes: int, progress, checkpoint: str | None,
                mesh=None, rows: tuple[int, int] | None = None) -> np.ndarray:
    """Host loop over groups of sample chunks.  Each group's mean is
    added into a float64 image on the scene's device, in group order,
    which is fetched to the host once, at the end; where a ``checkpoint``
    path is given it is also fetched and saved after every group, so a
    killed render resumes at the last group boundary.  ``progress`` gets
    the completed fraction in [0, 1], once a group, after the group's work
    has finished.

    A render of several groups with neither a checkpoint nor a mesh keeps
    one group queued ahead (:func:`_lookahead`): group k+1 is issued
    before the host waits for group k, so the device runs it while the
    host adds group k in and calls ``progress``.  A checkpointed render
    saves the groups finished, and a sharded one waits in its gather, so
    both issue a group after the last one has finished, as does a render
    of one group, which has nothing to overlap.

    With a ``mesh``, the pixels are sharded over its ranks
    (:func:`_render_group`): every rank then holds the whole image, and
    rank 0 alone writes the checkpoint and reads it back for all.
    ``rows = (lo, hi)`` renders the image's rows ``lo..hi-1`` alone, a
    rank's band, tiled and sampled as the whole image is, so that they are
    its rows to the bit; rows past the top re-render the top row.  It
    returns ``(hi - lo, W, 3)`` and takes no checkpoint.

    While a profiler records, the loop is the span ``image_loop``, with
    each group's ``issue`` (:func:`_retry_launch`), its ``wait`` where a
    group is queued ahead, ``accumulate``, ``progress``, and ``fetch``
    and ``checkpoint`` where a path is given, inside it, and the last
    ``fetch``."""
    data, spec = scene.data, scene.spec
    w, h = spec.width, spec.height
    lo, hi = rows if rows is not None else (0, h)
    if rows is not None and checkpoint is not None:
        raise ValueError("a band of rows takes no checkpoint")
    aa = spp if spp is not None else max(spec.antialias, 1)
    s_launch, p_launch = _s_p_launch(spec, aa, max_lanes)
    with span(IMAGE_LOOP):
        acc, s_done = _resume_state(checkpoint, w, hi - lo, aa, seed,
                                    data.device, mesh)
        writer = checkpoint is not None and (mesh is None or mesh.rank == 0)

        pix = torch.arange(lo * w, hi * w, dtype=id_dtype(hi * w),
                           device=data.device)
        px, py = pix % w, pix // w
        if hi > h:
            py.clamp_(max=h - 1)
        groups = list(sample_groups(spec, aa, s_launch, s_done))

        def issue(k, wait=False):
            s0, sl, g = groups[k]
            return _retry_launch(_render_group, mesh, data, spec, px, py, s0,
                                 sl, g, seed, p_launch, wait=wait)

        def finish(k, out):
            s0, sl, g = groups[k]
            n_s = g * sl
            _accumulate(acc, out, n_s / aa)
            if progress is not None:
                with span(PROGRESS):
                    progress((s0 + n_s) / aa)
            if writer:
                image = _fetch(acc)
                with span(CHECKPOINT):
                    _save_checkpoint(checkpoint, image=image,
                                     s_done=s0 + n_s, width=w, height=h,
                                     aa=aa, seed=seed)

        k0 = 0
        if checkpoint is None and mesh is None and len(groups) > 1:
            k0 = _lookahead(len(groups), issue, finish)
        for k in range(k0, len(groups)):
            finish(k, issue(k, wait=True))
        image = _fetch(acc)
    return image.reshape(hi - lo, w, 3)


def render_image(scene: Scene, *, seed: int = 0, spp: int | None = None,
                 max_lanes: int = 1 << 22, progress=None,
                 checkpoint: str | None = None) -> np.ndarray:
    """Render the full image on the scene's device.  Returns an (H, W, 3)
    float64 array of linear radiance, row 0 = *bottom* row (BMP order).

    ``spp`` overrides the scene's antialias count, ``max_lanes`` bounds
    the lanes of one launch, and ``checkpoint`` (an npz path) enables
    resume at sample-chunk boundaries.
    """
    return _image_loop(scene, seed=seed, spp=spp, max_lanes=max_lanes,
                       progress=progress, checkpoint=checkpoint)
