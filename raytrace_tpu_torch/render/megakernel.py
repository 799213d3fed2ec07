"""The render megakernels: per-lane radiance through one CUDA kernel.

PyTorch counterpart of :mod:`raytrace_tpu.render.megakernel` for scenes
of any object count in float32, with a solid background or a skybox.
:func:`radiance_lanes` takes per-lane integer identities (pixel x, pixel
y, antialias sample, lens sample) and returns their radiance: four (N,)
tensors, or a render launch's lanes in factored form, a
:class:`LaunchLanes` of pixels, samples and lens samples, which each
thread of a kernel decodes into its own lane.  On CUDA
tensors it launches a hand-written kernel or raises: linear scenes
(``children_per_ray <= 1``) go to ``csrc/megakernel_linear.cu``, fan-out
scenes to ``csrc/megakernel_tree.cu``, one thread per lane each.  Above
``LARGE_SCENE_THRESHOLD`` live objects both kernels answer closest-hit
and shadow queries by folding over the scene's unified primitive table
(their large instances; the table staged in shared memory when it fits,
:func:`raytrace_tpu_torch.ops.intersect_scan.fold_in_shared`), the tree
kernel takes the stack instance that :func:`tree_instance` names (its
stack in local memory up to 256 entries, above that in a slab of device
memory that the wrapper allocates), and a skybox scene takes the
instances that look the cube up where a ray misses.  While a ring
context is installed (an object-sharded render,
:mod:`raytrace_tpu_torch.parallel.ring`) no kernel holds the scene, and
:func:`radiance_lanes_ring` runs the ring instances of both kernels
(``csrc/ring_shade.cu``, :mod:`raytrace_tpu_torch.render.ring_shade`):
their node body one round a launch, the ring answering its queries
between launches.  On CPU tensors it runs their plain PyTorch version,
:func:`radiance_lanes_reference` (under a ring context, its queries go
round the ring).  Gradients: the forward pass is the kernel, the
backward pass differentiates the plain version on the same lanes
(:mod:`raytrace_tpu_torch.ops.kernel_grad`).
:func:`radiance_lanes_split` is a one-shard ring on the lanes' device:
the ring instances with every scan answered by the CUDA scan kernel
(:mod:`raytrace_tpu_torch.ops.intersect_scan`).  On CPU tensors every
scene renders, float64 included; on CUDA tensors every float32 scene
goes through a kernel, whatever its DFS stack, and a float64 scene
(outside :func:`usable`) raises ``NotImplementedError`` naming the
ROADMAP item: nothing there gives way to the plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from raytrace_tpu_torch.models import backgrounds
from raytrace_tpu_torch.ops import _build, intersect, intersect_scan
from raytrace_tpu_torch.ops.intersect import (LARGE_SCENE_THRESHOLD,
                                              object_table, per_scene_cache,
                                              scene_tables)
from raytrace_tpu_torch.ops.intersect_scan import OBJ_CHUNK
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.scene.schema import (BG_SKYBOX, CAM_DEPTH_OF_FIELD,
                                             SceneData, SceneSpec)

KERNEL_LINEAR = _build.KERNEL_LINEAR
KERNEL_TREE = _build.KERNEL_TREE
KERNEL_SCAN = _build.KERNEL_SCAN
KERNEL_SKY = _build.KERNEL_SKY
KERNEL_RING = _build.KERNEL_RING
KERNELS = _build.KERNELS
# kernel launches in this process, per kernel
LAUNCHES = _build.LAUNCHES

# the tree kernel's stack instances: entries of a thread's stack in local
# memory (csrc/megakernel_tree.cu, CAP)
TREE_STACK_CAPS = (8, 16, 32, 64, 128, 256)
# the instance of deeper stacks: the stack in a slab of device memory
TREE_SLAB = 0
# bytes of stack a thread takes per entry: 13 words
TREE_ENTRY_BYTES = 52
# the most device memory one launch's slab takes; a deeper stack gets
# fewer threads in flight, each walking more lanes
TREE_SLAB_MAX_BYTES = 4 << 30

# floats per object row in the scene buffer: object_table()'s 22 columns,
# a small scene's precomputed constant and a pad (csrc/render_common.cuh,
# ROW), of the header and per light
_ROW, _HDR, _LROW = 24, 24, 16


def kernel_for(spec: SceneSpec) -> str:
    """The kernel that renders this scene."""
    return KERNEL_LINEAR if spec.children_per_ray <= 1 else KERNEL_TREE


def is_large(spec: SceneSpec) -> bool:
    """Whether the scene takes the kernels' table-fold instances."""
    return len(spec.live_objects()) > LARGE_SCENE_THRESHOLD


def tree_instance(cap: int) -> int:
    """The tree kernel's stack instance for a tree whose plain walk needs
    ``cap`` entries (``tree_loop_stack``: ``1 + (levels - 1)(m - 1)``):
    the smallest of ``TREE_STACK_CAPS`` that holds them, or ``TREE_SLAB``
    above 256.  The kernel keeps the node it runs in registers, so its own
    stack never holds more than ``cap - 1``; the instance holds ``cap``, as
    the kernel's guard asks.  A local-memory stack takes no shared memory;
    the slab is ``cap`` entries for each thread of the launch."""
    if cap < 1:
        raise ValueError(f"a DFS stack of {cap} entries")
    return next((c for c in TREE_STACK_CAPS if c >= cap), TREE_SLAB)


def launch_counts(spec: SceneSpec, n: int) -> dict:
    """What the wrapper's span of a render launch of ``n`` lanes counts
    while a profiler records, for the linear and the tree kernel alike:
    ``lanes``, and the instance the scene takes, ``large`` (1 where it
    folds a large scene's table, else 0), ``lights`` (the scene's lights)
    and ``lens`` (the camera's lens samples, of which a launch's lanes
    take every one); for the tree kernel also ``stack`` (one of
    ``TREE_STACK_CAPS``, or ``TREE_SLAB``).  :func:`radiance_lanes` adds
    ``factored``: 1 where the kernel decodes the launch's lanes from a
    :class:`LaunchLanes`, 0 where it reads four lane tensors."""
    counts = {"lanes": n, "large": int(is_large(spec)),
              "lights": spec.n_lights, "lens": spec.cam_samples}
    if kernel_for(spec) != KERNEL_TREE:
        return counts
    from raytrace_tpu_torch.render.integrator import tree_loop_stack

    return dict(counts, stack=tree_instance(tree_loop_stack(spec)[3]))


def scene_shared_bytes(spec: SceneSpec) -> int:
    """Bytes of the scene buffer that a block stages in shared memory: the
    header, the lights, and a small scene's object rows
    (csrc/render_common.cuh, scene_bytes)."""
    rows = 0 if is_large(spec) else len(spec.live_objects())
    return 4 * (_HDR + _LROW * spec.n_lights + _ROW * rows)


def unsupported_reason(data: SceneData, spec: SceneSpec) -> str | None:
    """Why the kernels do not take this scene, or None: they take every
    float32 scene."""
    if data.dtype != torch.float32:
        return ("the kernels are float32; float64 renders on CPU tensors, "
                "as in the reference (ROADMAP item 12)")
    return None


def usable(data: SceneData, spec: SceneSpec) -> bool:
    """Whether this scene renders through the kernels (on CPU tensors
    :func:`radiance_lanes` renders every scene)."""
    return unsupported_reason(data, spec) is None


@dataclasses.dataclass(frozen=True)
class LaunchLanes:
    """A render launch's lanes in factored form: every (pixel, sample,
    lens sample) of the (P,) pixels ``px``, ``py``, the (S,) ``sample_ids``
    and ``cam_samples`` C lens samples, N = P S C lanes, lane i being pixel
    i // (S C), sample (i // C) % S and lens sample i % C
    (:func:`raytrace_tpu_torch.render.integrator.lane_ids`' order)."""
    px: torch.Tensor
    py: torch.Tensor
    sample_ids: torch.Tensor
    cam_samples: int

    def __post_init__(self):
        p, s = self.px, self.sample_ids
        if (p.ndim != 1 or self.py.shape != p.shape or s.ndim != 1
                or self.py.device != p.device or s.device != p.device):
            raise ValueError("a launch's pixels and sample ids must be "
                             "(P,) and (S,) tensors on one device")
        if self.cam_samples < 1:
            raise ValueError(f"{self.cam_samples} lens samples")

    @property
    def device(self) -> torch.device:
        return self.px.device

    @property
    def n(self) -> int:
        return self.px.shape[0] * self.sample_ids.shape[0] * self.cam_samples

    def expand(self) -> tuple:
        """The four (N,) identity tensors of these lanes."""
        from raytrace_tpu_torch.render.integrator import lane_ids

        return lane_ids(self.px, self.py, self.sample_ids, self.cam_samples)


def lane_args(lanes: tuple) -> tuple:
    """``(pix, piy, aa, cam, seed)`` of a call's ``lanes`` in either form
    that :func:`radiance_lanes` takes: the four (N,) tensors as they come,
    a :class:`LaunchLanes` expanded."""
    if len(lanes) == 2 and isinstance(lanes[0], LaunchLanes):
        return (*lanes[0].expand(), lanes[1])
    if len(lanes) != 5:
        raise TypeError("lanes are (pix, piy, aa, cam, seed) or "
                        "(LaunchLanes, seed)")
    return lanes


def radiance_lanes(data: SceneData, spec: SceneSpec, *lanes) -> V3:
    """Radiance of each lane on the scene's device, the lanes given as
    ``(pix, piy, aa, cam, seed)``, four (N,) integer identity tensors, or
    as ``(LaunchLanes, seed)``.  Returns a V3 of (N,) tensors of the
    scene's dtype, differentiable in every float leaf of the scene.  CPU
    tensors take the plain version whatever the scene; CUDA tensors a
    kernel (the ring instances while a ring context is installed, forward
    only: they raise ``NotImplementedError`` where a gradient is wanted,
    ROADMAP item 13), or ``NotImplementedError`` for a scene outside
    :func:`usable`.  A :class:`LaunchLanes` reaches the kernel as it is,
    each thread decoding its own lane, where no ring context is installed
    and no leaf of the scene wants a gradient; everywhere else it is
    expanded into the four tensors first."""
    factored = isinstance(lanes[0], LaunchLanes)
    if factored:
        device = lanes[0].device
    else:
        pix = lanes[0]
        device = pix.device
        for t in lanes[:4]:
            if t.device != device or t.shape != pix.shape or t.ndim != 1:
                raise ValueError("lane ids must be (N,) tensors on one "
                                 "device")
    if data.device != device:
        raise ValueError(f"scene on {data.device}, lanes on {device}")
    if device.type == "cpu":
        return radiance_lanes_reference(data, spec, *lanes)
    if device.type == "cuda":
        reason = unsupported_reason(data, spec)
        if reason is not None:
            raise NotImplementedError(reason)
        ctx = intersect.ring_ctx()
        if ctx is not None:
            # here, before the kernel's forward turns grad mode off
            from raytrace_tpu_torch.parallel.ring import refuse_grad
            refuse_grad(ctx, data)
        if factored and (ctx is not None or torch.is_grad_enabled() and any(
                getattr(data, f.name).requires_grad
                for f in dataclasses.fields(data))):
            lanes, factored = lane_args(lanes), False
        n = lanes[0].n if factored else lanes[0].shape[0]
        fwd, name, counts = (
            (_launch, kernel_for(spec),
             dict(launch_counts(spec, n), factored=int(factored)))
            if ctx is None
            else (radiance_lanes_ring, KERNEL_RING, {"lanes": n}))
        # the kernel forward; backward through the plain version, under the
        # ring context of the forward pass
        leaves = [getattr(data, f.name) for f in dataclasses.fields(data)]
        return V3(*kernel_forward(
            lambda *ls: fwd(SceneData(*ls), spec, *lanes),
            lambda *ls: _reference_under(ctx, SceneData(*ls), spec, *lanes),
            *leaves, name=name, **counts))
    raise ValueError(f"no megakernel for device {device}")


def _reference_under(ctx, *args) -> V3:
    """:func:`radiance_lanes_reference` with the ring context ``ctx`` (or
    none) installed."""
    prev = intersect.set_ring_ctx(ctx)
    try:
        return radiance_lanes_reference(*args)
    finally:
        intersect.set_ring_ctx(prev)


def radiance_lanes_ring(data: SceneData, spec: SceneSpec, pix, piy, aa, cam,
                        seed: int) -> V3:
    """The ring instances of the render kernels on the installed ring
    context's shards: :func:`raytrace_tpu_torch.parallel.ring.ring_radiance`
    with the kernels of ``csrc/ring_shade.cu`` as its step (on CUDA
    tensors they launch or raise)."""
    from raytrace_tpu_torch.parallel.ring import ring_radiance

    ctx = intersect.ring_ctx()
    if ctx is None:
        raise ValueError("the ring instances need an installed ring context")
    return ring_radiance(ctx, data, spec, pix, piy, aa, cam, seed)


def radiance_lanes_reference(data: SceneData, spec: SceneSpec,
                             *lanes) -> V3:
    """The plain PyTorch version of the kernels, on any device, on lanes
    in either form that :func:`radiance_lanes` takes: the linear chain or
    the DFS, as :func:`kernel_for` picks the kernel.  A large scene goes
    through the plain scan of its table and launches no kernel (unless a
    ring context is installed: its queries then go round the ring, whose
    steps are the scan kernel on CUDA tensors)."""
    from raytrace_tpu_torch.render.integrator import (primary_rays,
                                                      radiance_linear_v,
                                                      radiance_tree_loop_v)

    ro, rd, k1, k2 = primary_rays(data, spec, *lane_args(lanes))
    fn = (radiance_linear_v if kernel_for(spec) == KERNEL_LINEAR
          else radiance_tree_loop_v)
    return fn(data, spec, ro, rd, k1, k2)


def radiance_lanes_split(data: SceneData, spec: SceneSpec, pix, piy, aa,
                         cam, seed: int) -> V3:
    """The split path of a large scene: a ring of one shard on the lanes'
    device (:func:`raytrace_tpu_torch.parallel.ring.ring_context`), so
    :func:`radiance_lanes` under the ring: on CUDA tensors the ring
    instances, whose closest-hit and shadow queries are answered by
    :func:`raytrace_tpu_torch.ops.intersect_scan.scan_hit` (the CUDA scan
    kernel, one launch per query); on CPU tensors the plain version."""
    from raytrace_tpu_torch.parallel.mesh import Mesh
    from raytrace_tpu_torch.parallel.ring import ring_context

    if not is_large(spec):
        raise ValueError(f"the split path is for scenes of more than "
                         f"{LARGE_SCENE_THRESHOLD} objects")
    with ring_context(data, spec, Mesh(pix.device)) as stripped:
        return radiance_lanes(stripped, spec, pix, piy, aa, cam, seed)


def _header_parts(data: SceneData, spec: SceneSpec) -> list:
    """The scene buffer's header and light rows (:func:`pack_scene`), as
    the tensors to concatenate."""
    halfw, halfh = spec.width / 2.0, spec.height / 2.0
    # every number taken from the spec, in one host-to-device copy
    host = torch.tensor([halfw, halfh, max(1.0 / halfw, 1.0 / halfh),
                         spec.min_significance, 0.0, 0.0, *spec.light_type],
                        dtype=torch.float64).to(device=data.device,
                                                dtype=data.dtype)
    n_l = spec.n_lights
    lights = torch.cat([host[6:, None], data.light_p[:n_l],
                        data.light_e1[:n_l], data.light_e2[:n_l],
                        data.light_color[:n_l],
                        torch.zeros_like(data.light_p[:n_l])], dim=1)
    return [data.cam_position, data.cam_matrix.reshape(9), data.bg_color,
            host[:4], data.cam_focus.reshape(1), data.cam_aperture.reshape(1),
            data.cam_im_dist.reshape(1), host[4:6], lights.reshape(-1)]


def kernel_rows(rows: torch.Tensor) -> torch.Tensor:
    """``object_table`` rows padded to the kernels' ``_ROW`` floats, as a
    large scene's rows are packed (the two columns of a small scene's
    constant and pad left 0)."""
    return torch.cat([rows, rows.new_zeros((*rows.shape[:-1],
                                            _ROW - rows.shape[-1]))], dim=-1)


def pack_scene(data: SceneData, spec: SceneSpec) -> torch.Tensor:
    """The kernels' float32 scene buffer on the scene's device
    (csrc/render_common.cuh): a 24-float header (camera position,
    row-major camera matrix, background color, half width, half height,
    NDC scale, minimum significance, focal distance, aperture, image
    distance, two pads), then 16 floats per light (type, position, first
    and second edge, color, three pads), then 24-float object rows: the
    columns of ``object_table``, the constant of the object's intersection
    test as the plain version rounds it (a sphere's ``r * r``, a plane's
    ``p.n``: three products summed left to right) and a pad.  A small
    scene has one row per live object in scene order; a large scene one
    per object, indexed by object id, with the constant left 0 (the large
    instances read these rows from device memory and fold over
    :func:`raytrace_tpu_torch.ops.intersect.scene_tables`)."""
    rows = object_table(data, spec)
    if is_large(spec):
        rows = kernel_rows(rows)
    else:
        rows = rows[spec.live_objects()]
        p, q = rows[:, 0:3], rows[:, 3:6]
        # the plain version's roundings: r * r; (p0 q0 + p1 q1) + p2 q2
        pre = torch.stack([torch.where(
            rows[:, 21] > 0.5, q[:, 0] * q[:, 0],
            p[:, 0] * q[:, 0] + p[:, 1] * q[:, 1] + p[:, 2] * q[:, 2]),
            torch.zeros_like(rows[:, 0])], dim=1)
        rows = torch.cat([rows, pre], dim=1)
    return torch.cat(_header_parts(data, spec)
                     + [rows.reshape(-1)]).to(torch.float32).contiguous()


def pack_header(data: SceneData, spec: SceneSpec) -> torch.Tensor:
    """:func:`pack_scene` without object rows: the header and the lights,
    which is what the ring instances read of the scene (the rows come
    round the ring).  Reads no per-object leaf."""
    return torch.cat(_header_parts(data, spec)).to(torch.float32).contiguous()


# the last scene buffer packed, reused while the scene is unchanged
_scene_buffer = per_scene_cache(pack_scene)


# lane ids, their samples and lens samples (0, 0: four words a lane);
# scene buffer, fold buffer; sphere chunks, chunks, fold in shared memory;
# packed sky faces, face sizes; objects, lights, max_depth, reflect,
# refract, indirect, dof
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_uint32] * 2
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7)


# the libraries whose entry points have their argument types set, by name
_typed: dict[str, ctypes.CDLL] = {}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.load(name)
    if _typed.get(name) is lib:
        return lib
    fn = getattr(lib, f"rt_{name}")
    # the tree kernel: m, stack entries, the slab, its threads and its
    # counter of lanes taken
    extra = ([ctypes.c_int] * 2 + [ctypes.c_void_p, ctypes.c_longlong,
                                   ctypes.c_void_p]
             if name == KERNEL_TREE else [])
    fn.argtypes = _ARGTYPES + extra + [ctypes.c_uint32, ctypes.c_void_p,
                                       ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if name == KERNEL_TREE:
        lib.rt_megakernel_tree_slab_threads.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
            + [ctypes.POINTER(ctypes.c_longlong)])
        lib.rt_megakernel_tree_attrs.argtypes = [ctypes.c_int] * 3 + [
            ctypes.POINTER(ctypes.c_int)]
    lib.rt_error_string.argtypes = [ctypes.c_int]
    lib.rt_error_string.restype = ctypes.c_char_p
    _typed[name] = lib
    return lib


def _check(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.rt_error_string(rc).decode()}")


def tree_instance_attrs(cap: int, large: int, sky: bool) -> dict:
    """What the runtime reports of the tree kernel's instance ``cap``
    (``TREE_SLAB`` or one of ``TREE_STACK_CAPS``; ``large`` 0 for a small
    scene, 1 or 2 for a large one with its fold buffer in device or shared
    memory) on the current card: registers and local memory a thread
    (``cudaFuncGetAttributes``).  Builds the kernel if needed."""
    lib = _lib(KERNEL_TREE)
    out = (ctypes.c_int * 4)()
    _check(lib, lib.rt_megakernel_tree_attrs(cap, large, int(sky), out),
           "cudaFuncGetAttributes")
    return {"registers": out[0], "local_bytes": out[1],
            "static_shared_bytes": out[2], "max_block_threads": out[3]}


def tree_slab(lib, cap: int, n: int, n_obj: int, n_light: int, tables,
              sky: bool, device) -> tuple[torch.Tensor, int]:
    """The slab of a launch of the slab instance for ``n`` lanes with
    ``cap`` entries a thread, and its threads
    (``rt_megakernel_tree_slab_threads``: those the card holds resident,
    within ``TREE_SLAB_MAX_BYTES``), after two words that hold the launch's
    counter of lanes taken (8-byte aligned, as the allocator's blocks
    are)."""
    threads = ctypes.c_longlong()
    with torch.cuda.device(device):
        _check(lib, lib.rt_megakernel_tree_slab_threads(
            n_obj, n_light, tables[2], tables[3], int(sky), cap, n,
            TREE_SLAB_MAX_BYTES, ctypes.byref(threads)), "the slab's sizing")
    words = threads.value * cap * (TREE_ENTRY_BYTES // 4)
    return (torch.empty(words + 2, dtype=torch.int32, device=device),
            threads.value)


def _words(t: torch.Tensor) -> torch.Tensor:
    """Integer ids as the 32-bit words that the kernels read as uint32_t:
    an int32 tensor as it is, another's low 32 bits in an int32 copy."""
    if t.dtype == torch.int32:
        return t.contiguous()
    return (t.to(torch.int64) & 0xFFFFFFFF).to(torch.int32).contiguous()


def _launch(data: SceneData, spec: SceneSpec, *lanes) -> V3:
    """One launch of the scene's kernel on ``lanes`` in either form that
    :func:`radiance_lanes` takes: a :class:`LaunchLanes` as its (P,)
    pixels, (S,) sample ids and lens-sample count, which the kernel
    decodes lane by lane, or four (N,) tensors, a word each a lane."""
    from raytrace_tpu_torch.render.integrator import tree_loop_stack

    if isinstance(lanes[0], LaunchLanes):
        launch, seed = lanes
        n = launch.n
        if n > 0xFFFFFFFF:
            raise ValueError(f"{n} lanes: a factored launch decodes 32-bit "
                             f"lane indices")
        ids = [_words(t) for t in (launch.px, launch.py, launch.sample_ids)]
        ids.append(None)
        factors = [launch.sample_ids.shape[0], launch.cam_samples]
    else:
        pix, piy, aa, cam, seed = lanes
        n = pix.shape[0]
        ids = [_words(t) for t in (pix, piy, aa, cam)]
        factors = [0, 0]
    device = data.device
    out = torch.empty((3, n), dtype=torch.float32, device=device)
    if n == 0:
        return V3(out[0], out[1], out[2])
    name = kernel_for(spec)
    lib = _lib(name)
    scene = _scene_buffer(data, spec)
    large = is_large(spec)
    if large:
        # the large instances: n_chunks > 0, rows indexed by object id
        tb = scene_tables(data, spec)
        if tb.table.dtype != torch.float32:
            raise ValueError("the scene's tables must be float32")
        fold = intersect_scan.cached_fold_buffer(tb.table, tb.ids,
                                                  tb.n_sph_pad, tb.bounds)
        n_chunks = tb.table.shape[0] // OBJ_CHUNK
        tables = [fold.data_ptr(), tb.n_sph_pad // OBJ_CHUNK, n_chunks,
                  int(intersect_scan.fold_in_shared(
                      n_chunks, scene_shared_bytes(spec), device))]
        n_obj = spec.n_objects
        if tables[0] % 16:
            raise ValueError("the fold buffer must be 16-byte aligned")
    else:
        tables = [None, 0, 0, 0]
        n_obj = len(spec.live_objects())
    if spec.bg_type == BG_SKYBOX:
        # the skybox instances: the faces packed for the lookup where a ray
        # misses (16/3 of the cube's bytes, in device memory), made once
        # per cube and again after the cube changes
        quads, face_hw = backgrounds.sky_buffer(data.bg_cube, spec)
        sky = [quads.data_ptr(), face_hw]
    else:
        sky = [None, None]
    args = [*(None if t is None else t.data_ptr() for t in ids), *factors,
            scene.data_ptr(), *tables, *sky,
            n_obj, spec.n_lights, spec.max_depth,
            int(spec.has_reflect), int(spec.has_refract), spec.n_indirect,
            int(spec.cam_type == CAM_DEPTH_OF_FIELD)]
    if name == KERNEL_TREE:
        m, _, _, cap = tree_loop_stack(spec)
        inst = tree_instance(cap)
        if inst == TREE_SLAB:
            slab, threads = tree_slab(lib, cap, n, n_obj, spec.n_lights,
                                      tables, sky[0] is not None, device)
            args += [m, cap, slab.data_ptr() + 8, threads, slab.data_ptr()]
        else:
            args += [m, inst, None, 0, None]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"rt_{name}")(*args, int(seed) & 0xFFFFFFFF,
                                        out.data_ptr(), n, stream)
    _check(lib, rc, f"{name} launch")
    LAUNCHES[name] += 1
    return V3(*out.unbind(0))
