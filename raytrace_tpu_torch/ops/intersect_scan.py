"""Closest hit of N rays against the unified primitive table of a large
scene, as one CUDA kernel.

PyTorch counterpart of :mod:`raytrace_tpu.ops.intersect_pallas`.
:func:`scan_hit` launches ``csrc/scan_hit.cu`` on CUDA tensors (one
thread per ray, the fold of ``csrc/render_common.cuh`` that the render
kernels also call) or raises; on CPU tensors it runs the plain version,
:func:`scan_hit_reference`.  The kernels read the table in a layout of
their own, :func:`fold_buffer`, staged in a block's shared memory when
:func:`fold_in_shared` says that it fits.  Gradients of ``t`` with respect
to the table and the rays come from the plain version
(:mod:`raytrace_tpu_torch.ops.kernel_grad`); the forward pass is still
the kernel.

Table layout (:func:`raytrace_tpu_torch.ops.intersect._packed_tables`),
one ``(C * OBJ_CHUNK, 4)`` float32 table, spheres first:

* sphere row ``(cx, cy, cz, r)``; plane row ``(nx, ny, nz, p.n)``;
* zero pad rows are never valid: a sphere needs ``r > 0``, a zero plane
  normal gives ``denom == 0``; their ids are -1.

The result is the minimum of ``(t, global id)`` over the valid rows, so on
an exact tie in ``t`` the first object in scene order wins whatever the
order of the scan.  Miss lanes carry id ``2**31 - 1``: mask with ``hit``
before indexing.
"""

from __future__ import annotations

import ctypes

import torch

from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.utils import gpu_info

OBJ_CHUNK = 32               # table rows per chunk (one bounding sphere each)
ID_SENTINEL = 2 ** 31 - 1    # id of a lane that hit nothing

# bytes of a fold buffer per table row and per chunk
FOLD_ROW_BYTES, FOLD_CHUNK_BYTES = 20, 16
# the largest fold buffer, with whatever else the block keeps in shared
# memory, that a kernel stages there; None: derived from the card by
# fold_shared_max_bytes.  A number set here overrides it (the tools set it
# to time both places of one table).
FOLD_SHARED_MAX_BYTES = None
# the derived limit per CUDA device index
_fold_limits: dict[int, int] = {}


def _chunk_bounds(table: torch.Tensor, n_sph_pad: int,
                  n_chunks: int) -> torch.Tensor:
    """Conservative bounding spheres ``(cx, cy, cz, R)`` of the sphere
    chunks, (n_chunks, 4) float32: the centroid of the chunk's valid
    members with radius ``max(|c_i - C| + r_i)``, inflated by 1.0001 and
    1e-4, so that a ray that hits a member at t > 0 enters the bound
    earlier.  Plane chunks and all-pad chunks carry zeros."""
    sph = table[:n_sph_pad].detach().reshape(-1, OBJ_CHUNK, 4)
    valid = sph[..., 3] > 0
    cnt = torch.clamp(valid.sum(dim=1, keepdim=True), min=1)
    ctr = torch.where(valid[..., None], sph[..., :3], 0.0).sum(dim=1) / cnt
    dist = torch.sqrt(torch.sum((sph[..., :3] - ctr[:, None, :]) ** 2,
                                dim=-1)) + sph[..., 3]
    r = torch.where(valid, dist, 0.0).amax(dim=1)
    r = torch.where(r > 0, r * 1.0001 + 1e-4, 0.0)
    bounds = torch.cat([ctr, r[:, None]], dim=1)
    pad = bounds.new_zeros((n_chunks - bounds.shape[0], 4))
    return torch.cat([bounds, pad]).to(torch.float32)


def _may_enter(bound, ro: V3, rd: V3, a, inv2a, t_best):
    """Whether a chunk may improve each lane: the ray enters the chunk's
    bounding sphere in front of its origin and not beyond the running best
    t.  All three tests take slack relative to the quantities that carry
    the rounding error of ``b*b - 4ac``, so a grazing ray from far away
    never skips a chunk that holds a real hit."""
    ocx, ocy, ocz = ro.x - bound[0], ro.y - bound[1], ro.z - bound[2]
    b = 2.0 * (rd.x * ocx + rd.y * ocy + rd.z * ocz)
    cc = ocx * ocx + ocy * ocy + ocz * ocz - bound[3] * bound[3]
    disc = b * b - 4.0 * a * cc
    pos = disc > -1e-5 * (b * b)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    margin = 1e-5 * torch.abs(b) * inv2a + 1e-4
    enters = pos & ((-b + sq) * inv2a > -margin)
    return enters & ((-b - sq) * inv2a <= t_best + margin)


def fold_buffer(table, ids, n_sph_pad: int, bounds) -> torch.Tensor:
    """The table as the kernels' folds read it, one flat int32 tensor of
    ``(C*32) * 5 + C * 4`` words on the table's device (the float parts
    bit-cast): the rows ``(C*32, 4)``, then the ids ``(C*32,)``, then the
    bounds ``(C, 4)``.  A sphere row's fourth column holds ``r * r``, the
    float32 product that the plain scan squares for every ray, in place of
    ``r``, and ``-inf`` where the plain scan rejects the row whatever the
    ray (a pad row, a radius that is not positive): the test's discriminant
    is then never positive.  Plane rows are the table's own."""
    table = table.detach()
    n_rows = table.shape[0]
    r = table[:n_sph_pad, 3]
    r2 = torch.where((r > 0) & (ids[:n_sph_pad] >= 0), r * r, float("-inf"))
    rows = torch.cat([torch.cat([table[:n_sph_pad, :3], r2[:, None]], dim=1),
                      table[n_sph_pad:]])
    if bounds.shape != (n_rows // OBJ_CHUNK, 4):
        raise ValueError("bounds must hold one row per chunk")
    return torch.cat([rows.contiguous().view(torch.int32).reshape(-1),
                      ids.to(torch.int32),
                      bounds.contiguous().view(torch.int32).reshape(-1)])


def fold_ids_bounds(fold, table):
    """The ids and the chunk bounds that :func:`fold_buffer` holds, as
    views into ``fold`` (``table`` is the table it was made from)."""
    n_rows = table.shape[0]
    at = n_rows * table.element_size()   # the rows' words
    return (fold[at:at + n_rows],
            fold[at + n_rows:].view(torch.float32).reshape(-1, 4))


def fold_bytes(n_chunks: int) -> int:
    """Bytes of the fold buffer of a table of ``n_chunks`` chunks."""
    return n_chunks * (OBJ_CHUNK * FOLD_ROW_BYTES + FOLD_CHUNK_BYTES)


def fold_shared_max_bytes(device=None) -> int:
    """The largest fold buffer, with whatever else the block keeps in
    shared memory, that a kernel stages there on a CUDA device (the
    current one by default): ``FOLD_SHARED_MAX_BYTES`` when set, else
    :func:`raytrace_tpu_torch.utils.gpu_info.fold_shared_max_bytes` of the
    card at the registers of the fold at its leanest, the scan kernel
    reading its table from device memory (``rt_scan_hit_attrs``): the
    blocks an SM holds of that kernel share its shared memory.  On an H100
    that instance takes 48 registers, five blocks of 256 threads, and the
    limit is 44 KB, the edge that was timed (PERF.md): a larger table is
    read from device memory through the read-only cache (at 83 KB, 4,006
    objects, staging it left two blocks an SM and cost 17%).  The instances that stage the
    table take 62-64 registers, four blocks (PERF.md).  Builds the scan
    kernel if needed."""
    if FOLD_SHARED_MAX_BYTES is not None:
        return FOLD_SHARED_MAX_BYTES
    d = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if d.index is None else d.index
    if index not in _fold_limits:
        lib = _lib()
        out = (ctypes.c_int * 4)()
        with torch.cuda.device(index):
            rc = lib.rt_scan_hit_attrs(0, out)
        if rc != 0:
            raise RuntimeError(f"cudaFuncGetAttributes failed: "
                               f"{lib.rt_error_string(rc).decode()}")
        _fold_limits[index] = gpu_info.fold_shared_max_bytes(
            gpu_info.device_card(index), out[0])
    return _fold_limits[index]


def fold_in_shared(n_chunks: int, other_bytes: int = 0,
                   device=None) -> bool:
    """Whether a kernel on ``device`` stages the fold buffer of
    ``n_chunks`` chunks in shared memory, beside ``other_bytes`` that its
    block keeps there anyway (the scene's header and lights)."""
    return (fold_bytes(n_chunks) + other_bytes
            <= fold_shared_max_bytes(device))


# the last fold buffer made, reused while the same tensors come unmodified
_fold_last = None


def cached_fold_buffer(table, ids, n_sph_pad: int, bounds) -> torch.Tensor:
    """:func:`fold_buffer`, made anew only when a tensor is another one or
    was modified (a scene's tables are themselves cached per scene)."""
    global _fold_last
    key = (table, ids, bounds)
    versions = (n_sph_pad, *(t._version for t in key))
    if (_fold_last is not None and _fold_last[1] == versions
            and all(a is b for a, b in zip(_fold_last[0], key))):
        return _fold_last[2]
    buf = fold_buffer(table, ids, n_sph_pad, bounds)
    _fold_last = (key, versions, buf)
    return buf


def scan_hit_reference(table, ids, n_sph_pad: int, ro: V3, rd: V3,
                       bounds=None, return_entered: bool = False,
                       return_mask: bool = False):
    """The plain PyTorch version of the kernel, on any device: ``(t_best,
    global id, hit)`` of (N,) rays, folded chunk by chunk with each row
    broadcast against the lanes; every element's arithmetic is the
    kernel's formula.

    With ``bounds`` (:func:`_chunk_bounds`) a lane skips the sphere chunks
    it cannot be improved by, as the kernel does; the result is the same
    bit for bit.  ``return_entered`` adds the number of sphere chunks each
    lane folded, ``return_mask`` (after it) which ones: an ``(N, sphere
    chunks)`` bool tensor."""
    a = rd.x * rd.x + rd.y * rd.y + rd.z * rd.z
    inv2a = 0.5 / torch.where(a > 0, a, 1.0)
    n_rows = table.shape[0]
    if n_rows % OBJ_CHUNK or n_sph_pad % OBJ_CHUNK:
        raise ValueError(f"table partitions must be multiples of {OBJ_CHUNK}")
    t_best = torch.full_like(ro.x, float("inf"))
    obj = torch.full(ro.x.shape, ID_SENTINEL, dtype=torch.int32,
                     device=ro.x.device)
    hit = torch.zeros(ro.x.shape, dtype=torch.bool, device=ro.x.device)
    entered = torch.zeros(ro.x.shape, dtype=torch.int64, device=ro.x.device)
    mask = []
    ox, oy, oz = ro.x[:, None], ro.y[:, None], ro.z[:, None]
    dx, dy, dz = rd.x[:, None], rd.y[:, None], rd.z[:, None]
    a_, inv2a_ = a[:, None], inv2a[:, None]

    for r0 in range(0, n_rows, OBJ_CHUNK):
        rows = table[r0:r0 + OBJ_CHUNK]
        gid = ids[r0:r0 + OBJ_CHUNK]
        c0, c1, c2, c3 = rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3]
        if r0 < n_sph_pad:
            ocx, ocy, ocz = ox - c0, oy - c1, oz - c2
            b = 2.0 * (dx * ocx + dy * ocy + dz * ocz)
            cc = ocx * ocx + ocy * ocy + ocz * ocz - c3 * c3
            disc = b * b - 4.0 * a_ * cc
            has = disc > 0.0
            sq = torch.sqrt(torch.where(has, disc, 1.0))
            t1 = (-b - sq) * inv2a_
            t2 = (-b + sq) * inv2a_
            t = torch.where(t1 > 0.0, t1, t2)
            valid = has & (t > 0.0) & (c3 > 0.0)
        else:
            denom = dx * c0 + dy * c1 + dz * c2
            numer = c3 - (ox * c0 + oy * c1 + oz * c2)
            ok = denom != 0.0
            t = numer / torch.where(ok, denom, 1.0)
            valid = ok & (t > 0.0)
        valid = valid & (gid >= 0)
        t = torch.where(valid, t, float("inf"))
        # the chunk's minimum of (t, id), then the running one
        t_c = t.amin(dim=1)
        g_c = torch.where(valid & (t == t_c[:, None]), gid,
                          ID_SENTINEL).amin(dim=1)
        better = (t_c < t_best) | ((t_c == t_best) & (g_c < obj))
        any_valid = valid.any(dim=1)
        if bounds is not None and r0 < n_sph_pad:
            may = _may_enter(bounds[r0 // OBJ_CHUNK], ro, rd, a, inv2a,
                             t_best)
            entered = entered + may
            mask.append(may)
            better = better & may
            any_valid = any_valid & may
        t_best = torch.where(better, t_c, t_best)
        obj = torch.where(better, g_c, obj)
        hit = hit | any_valid
    out = (t_best, obj, hit)
    if return_entered:
        out += (entered,)
    if return_mask:
        out += (torch.stack(mask, dim=1) if mask else
                torch.zeros((ro.x.shape[0], 0), dtype=torch.bool,
                            device=ro.x.device),)
    return out


_lib_ready: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    global _lib_ready
    if _lib_ready is None:
        lib = _build.load(_build.KERNEL_SCAN)
        lib.rt_scan_hit.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 3
            + [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_void_p])
        lib.rt_scan_hit.restype = ctypes.c_int
        lib.rt_scan_hit_attrs.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_int)]
        lib.rt_error_string.argtypes = [ctypes.c_int]
        lib.rt_error_string.restype = ctypes.c_char_p
        _lib_ready = lib
    return _lib_ready


def scan_hit(table, ids, n_sph_pad: int, ro: V3, rd: V3, bounds=None,
             fold=None):
    """``(t_best, global id, hit)`` of (N,) float32 rays against the
    unified table: ``table`` (C*32, 4) float32 with the spheres in rows
    ``[0, n_sph_pad)`` and the planes after, ``ids`` (C*32,) int32 global
    object id per row (-1 on pad rows).  ``bounds`` are the chunks'
    bounding spheres, computed here when not given; ``fold`` is the
    table's :func:`fold_buffer` (with those bounds), taken from
    :func:`cached_fold_buffer` when not given.  On CUDA tensors this
    launches the kernel or raises; on CPU tensors it runs
    :func:`scan_hit_reference`.  ``t_best`` is differentiable in the
    table and the rays, through the plain scan without culling; ids and
    hits take no gradient."""
    rays = (*ro, *rd)
    device = ro.x.device
    if any(t.device != device for t in (table, ids, *rays)):
        raise ValueError("table, ids and rays must lie on one device")
    if device.type == "cpu":
        return scan_hit_reference(table, ids, n_sph_pad, ro, rd)
    if device.type != "cuda":
        raise ValueError(f"no scan kernel for device {device}")

    n = ro.x.shape[0]
    n_rows = table.shape[0]
    if (table.dtype != torch.float32 or table.ndim != 2
            or table.shape[1] != 4 or n_rows % OBJ_CHUNK
            or n_sph_pad % OBJ_CHUNK or not 0 <= n_sph_pad <= n_rows):
        raise ValueError("table must be (C*32, 4) float32, spheres first")
    if ids.dtype != torch.int32 or ids.shape != (n_rows,):
        raise ValueError("ids must be (C*32,) int32")
    if any(t.dtype != torch.float32 or t.shape != (n,) for t in rays):
        raise ValueError("rays must be (N,) float32 tensors")
    n_chunks = n_rows // OBJ_CHUNK
    if bounds is None:
        bounds = _chunk_bounds(table, n_sph_pad, n_chunks)
    elif (bounds.dtype != torch.float32 or bounds.shape != (n_chunks, 4)
          or bounds.device != device):
        raise ValueError("bounds must be (C, 4) float32 on the rays' device")
    if fold is not None and (fold.dtype != torch.int32
                             or fold.shape != (fold_bytes(n_chunks) // 4,)
                             or fold.device != device):
        raise ValueError("fold must be the table's int32 fold buffer on the "
                         "rays' device")
    ids, bounds = ids.contiguous(), bounds.contiguous()
    return kernel_forward(
        lambda tab, *r: _launch(tab, ids, bounds, n_sph_pad, r, fold),
        lambda tab, *r: scan_hit_reference(tab, ids, n_sph_pad, V3(*r[:3]),
                                           V3(*r[3:])),
        table, *rays, name=_build.KERNEL_SCAN)


def _launch(table, ids, bounds, n_sph_pad: int, rays, fold=None):
    device = table.device
    n = rays[0].shape[0]
    n_chunks = table.shape[0] // OBJ_CHUNK
    if fold is None:
        fold = cached_fold_buffer(table, ids, n_sph_pad, bounds)
    rays = [t.detach().contiguous() for t in rays]
    if fold.data_ptr() % 16:
        raise ValueError("the fold buffer must be 16-byte aligned")

    t_out = torch.empty(n, dtype=torch.float32, device=device)
    gid = torch.empty(n, dtype=torch.int32, device=device)
    hit = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return t_out, gid, hit
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.rt_scan_hit(fold.data_ptr(), n_sph_pad // OBJ_CHUNK,
                             n_chunks, int(fold_in_shared(n_chunks,
                                                          device=device)),
                             *(t.data_ptr() for t in rays),
                             t_out.data_ptr(), gid.data_ptr(), hit.data_ptr(),
                             n, stream)
    if rc != 0:
        raise RuntimeError(f"scan_hit launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    _build.LAUNCHES[_build.KERNEL_SCAN] += 1
    return t_out, gid, hit
