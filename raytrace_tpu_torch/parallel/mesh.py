"""Ranks, their devices, and the collectives the parallel renders use.

PyTorch counterpart of :mod:`raytrace_tpu.parallel.mesh`.  A JAX mesh of
devices becomes a :class:`Mesh` of ``torch.distributed`` ranks, one
process and one device each: rank r renders on
``cuda:(r % torch.cuda.device_count())`` unless the caller names the
device (the tests name ``cpu``).  Without a process group a mesh has one
rank and every collective is the identity.

Multi-process bring-up keeps the JAX package's environment protocol:
``RAYTRACE_TPU_COORDINATOR`` (``host:port``) with
``RAYTRACE_TPU_NUM_PROCESSES`` and ``RAYTRACE_TPU_PROCESS_ID``, or
``RAYTRACE_TPU_DISTRIBUTED=1`` with torch's own ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``.  The backend is chosen
before anything runs, from the ranks' devices: NCCL when every rank has a
card of its own, gloo otherwise (CPU tensors; or more ranks than cards,
since NCCL refuses two ranks on one GPU).  A gloo group moves CUDA
tensors itself in all-reduce and broadcast, but takes only host tensors
in all-gather and point-to-point sends: those two stage a CUDA tensor
through host memory.  Only the transport goes through the host, never
the compute.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist


def rank_device(rank: int) -> torch.device:
    """The card rank ``rank`` renders on: ``cuda:(rank % cards)``."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device: pass the device (e.g. 'cpu') "
                           "explicitly")
    return torch.device("cuda", rank % n)


def backend_for(device_type: str, world_size: int) -> str:
    """NCCL when every rank has a card of its own, gloo otherwise."""
    if (device_type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= world_size):
        return "nccl"
    return "gloo"


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     device_type: str = "cuda") -> None:
    """Join the process group: ``coordinator`` (``host:port``), the
    process count and this process's rank, or, with none of them, torch's
    ``env://`` variables.  ``device_type`` is the kind of device the ranks
    render on, which picks the backend.  Idempotent."""
    if dist.is_initialized():
        return
    if coordinator is None:
        init = "env://"
        world = int(os.environ.get("WORLD_SIZE", "1"))
        rank = int(os.environ.get("RANK", "0"))
    else:
        init = (coordinator if "://" in coordinator
                else f"tcp://{coordinator}")
        world, rank = int(num_processes), int(process_id)
    if device_type == "cuda":
        torch.cuda.set_device(rank_device(rank))
    dist.init_process_group(backend_for(device_type, world),
                            init_method=init, world_size=world, rank=rank)


def maybe_init_distributed(device_type: str = "cuda") -> bool:
    """Join a process group iff the environment asks for it; called by
    the CLI before any device query.  Returns True when it joined."""
    coord = os.environ.get("RAYTRACE_TPU_COORDINATOR")
    if coord:
        init_distributed(
            coordinator=coord,
            num_processes=int(os.environ["RAYTRACE_TPU_NUM_PROCESSES"]),
            process_id=int(os.environ["RAYTRACE_TPU_PROCESS_ID"]),
            device_type=device_type)
        return True
    if os.environ.get("RAYTRACE_TPU_DISTRIBUTED", "") not in ("", "0"):
        init_distributed(device_type=device_type)
        return True
    return False


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a render, this rank and the device it renders on, with
    the JAX mesh's axis names and sizes (ranks in row-major order)."""

    device: torch.device
    axis_names: tuple[str, ...] = ("d",)
    axis_sizes: tuple[int, ...] = (1,)
    rank: int = 0

    @property
    def ranks(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def _device(device) -> torch.device:
    return (rank_device(process_index()) if device is None
            else torch.device(device))


def make_mesh(device=None, axis_name: str = "d") -> Mesh:
    """Flat mesh over every rank of the process group (one without)."""
    return Mesh(_device(device), (axis_name,), (process_count(),),
                process_index())


def make_mesh_2d(n_dcn: int | None = None, device=None) -> Mesh:
    """Two-level ("dcn", "ici") mesh: the outer axis across groups of
    ranks (hosts), the inner one across the ranks of each group.  ``n_dcn``
    defaults to 1."""
    n = process_count()
    n_dcn = 1 if n_dcn is None else n_dcn
    if n % n_dcn:
        raise ValueError(f"{n} ranks do not split into {n_dcn} groups")
    return Mesh(_device(device), ("dcn", "ici"), (n_dcn, n // n_dcn),
                process_index())


def _staged(t: torch.Tensor) -> bool:
    """Whether a collective that gloo runs on host tensors only must move
    ``t`` through host memory."""
    return t.is_cuda and dist.get_backend() == "gloo"


def _all_gather(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    src = t.cpu() if _staged(t) else t.contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.ranks)]
    dist.all_gather(outs, src)
    return [o.to(t.device) for o in outs]


class _AllGather(torch.autograd.Function):
    """:func:`all_gather` under autograd: every rank holds the same loss
    of the gathered tensors, so a rank's cotangent of its own ``t`` is its
    slice of the cotangents (a sum over the ranks would count it k
    times)."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.rank = mesh.rank
        return tuple(_all_gather(t, mesh))

    @staticmethod
    def backward(ctx, *cotangents):
        return cotangents[ctx.rank], None


def all_gather(t: torch.Tensor, mesh: Mesh) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s
    device.  Differentiable in ``t`` when every rank computes the same
    loss of the result; every rank then calls ``backward()``."""
    if mesh.ranks == 1:
        return [t]
    return list(_AllGather.apply(t, mesh))


class _Replicated(torch.autograd.Function):
    """Identity forward; backward sums each cotangent over the ranks."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *cotangents):
        return None, *(all_reduce_sum_(c.contiguous().clone(), ctx.mesh)
                       if need else None
                       for c, need in zip(cotangents,
                                          ctx.needs_input_grad[1:]))


def replicated(mesh: Mesh, *tensors) -> tuple[torch.Tensor, ...]:
    """The entry of tensors that every rank holds alike (the scene's leaves,
    the rays that the ranks split) into work that each rank does on its
    own part: the same tensors, whose gradient is the sum of every rank's,
    so that each rank ends with the whole gradient.  Every rank calls
    ``backward()`` together."""
    if mesh.ranks == 1:
        return tensors
    return _Replicated.apply(mesh, *tensors)


def all_reduce_sum_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place."""
    if mesh.ranks > 1:
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def collective_device(mesh: Mesh) -> torch.device:
    """Where a small tensor made for a collective lives: the host for
    gloo, the mesh's device for NCCL."""
    return (torch.device("cpu") if dist.get_backend() == "gloo"
            else mesh.device)


def all_reduce_max(value: int, mesh: Mesh) -> int:
    """The largest of the ranks' ``value`` (on the host for gloo, on the
    mesh's device for NCCL)."""
    if mesh.ranks == 1:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64,
                     device=collective_device(mesh))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def broadcast_(t: torch.Tensor, mesh: Mesh, src: int = 0) -> torch.Tensor:
    """Overwrite ``t`` with rank ``src``'s, in place."""
    if mesh.ranks > 1:
        dist.broadcast(t, src)
    return t


def _shift(tensors, mesh: Mesh, by: int) -> list[torch.Tensor]:
    """Send each tensor to rank + ``by`` and return what rank - ``by``
    sent."""
    k = mesh.ranks
    send = [t.cpu() if _staged(t) else t.contiguous() for t in tensors]
    recv = [torch.empty_like(s) for s in send]
    ops = []
    for tag, (s, r) in enumerate(zip(send, recv)):
        ops.append(dist.P2POp(dist.isend, s, (mesh.rank + by) % k, tag=tag))
        ops.append(dist.P2POp(dist.irecv, r, (mesh.rank - by) % k, tag=tag))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [r.to(t.device) for r, t in zip(recv, tensors)]


class _RingShift(torch.autograd.Function):
    """:func:`ring_shift` under autograd: the cotangents of the floating
    tensors go the other way round the ring, to rank - 1."""

    @staticmethod
    def forward(ctx, mesh, *tensors):
        ctx.mesh = mesh
        ctx.floating = [t.is_floating_point() for t in tensors]
        out = _shift(tensors, mesh, 1)
        ctx.mark_non_differentiable(
            *(o for o in out if not o.is_floating_point()))
        return tuple(out)

    @staticmethod
    def backward(ctx, *cotangents):
        back = iter(_shift([c for c, f in zip(cotangents, ctx.floating) if f],
                           ctx.mesh, -1))
        return None, *(next(back) if f else None for f in ctx.floating)


def ring_shift(tensors, mesh: Mesh) -> list[torch.Tensor]:
    """The ring's hand-off: send each tensor to rank + 1 and return what
    rank - 1 sent (same shapes and dtypes), on the tensors' devices.
    Differentiable in the floating tensors: their cotangents go back to
    rank - 1, so every rank of the ring calls ``backward()`` together."""
    if mesh.ranks == 1:
        return list(tensors)
    return list(_RingShift.apply(mesh, *tensors))
