"""Process groups for the port's multi-rank tests, and the jobs their ranks
run.  No test here: the test files start groups with :func:`run_group`.

Each group is ``n`` spawned processes joined by a gloo group on the CPU
(``raytrace_tpu_torch.parallel.mesh.init_distributed`` at a free port on
``localhost``); rank r runs ``job(*args)`` and pickles its result for the
test to read.  A group has a time limit of its own and fails on it, so
that a hung rendezvous never takes the suite's time.  This module imports
no JAX, so that the ranks start quickly.
"""

import multiprocessing
import os
import pickle
import socket
import time

# the ring gradient tests' losses, one copy with the card's check's
from chip_smoke import grad_losses

# the longest a group may take, start to finish (each rank imports torch
# and the port, a few seconds, then renders a tiny image)
GROUP_TIMEOUT_S = 90


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _rank_main(job, coordinator, n, rank, out_dir, args):
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    init_distributed(coordinator, n, rank, device_type="cpu")
    try:
        result = job(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_group(job, n: int, *args, out_dir, timeout: float = GROUP_TIMEOUT_S):
    """Run ``job(*args)`` on each rank of an ``n``-rank gloo group; returns
    the ranks' results in rank order.  Fails if a rank fails or the group
    outlasts ``timeout`` seconds (its processes are then killed)."""
    ctx = multiprocessing.get_context("spawn")
    coordinator = f"localhost:{free_port()}"
    procs = [ctx.Process(target=_rank_main,
                         args=(job, coordinator, n, r, str(out_dir), args))
             for r in range(n)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    assert not hung, f"ranks {hung} of {n} still ran after {timeout} s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * n, f"rank exit codes {codes}"
    out = []
    for r in range(n):
        with open(os.path.join(str(out_dir), f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---- jobs (each rank builds its mesh on the CPU) ----

def _mesh():
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    return make_mesh("cpu")


def ring_intersect_job(data, spec, ro, rd):
    from raytrace_tpu_torch.parallel.ring import make_ring_intersector
    return make_ring_intersector(spec, _mesh())(data, ro, rd)


def ring_render_job(scene, seed, spp):
    from raytrace_tpu_torch.parallel.ring import render_image_ring
    return render_image_ring(scene, seed=seed, spp=spp, mesh=_mesh())


def sharded_render_job(scene, seed, spp):
    from raytrace_tpu_torch.parallel.tile import render_image_sharded
    return render_image_sharded(scene, seed=seed, spp=spp, mesh=_mesh())


def sharded_step_job(data, spec, px, py, sids, seed, target):
    from raytrace_tpu_torch.optim import make_sharded_step
    return make_sharded_step(spec, _mesh(), seed)(data, px, py, sids, target)


def rows_job(scene, seed, spp):
    from raytrace_tpu_torch.parallel.multihost import render_rows_multihost
    return render_rows_multihost(scene, seed=seed, spp=spp, mesh=_mesh())


def mesh_job():
    """The mesh's shapes, and each collective on rank-made tensors."""
    import torch

    from raytrace_tpu_torch.parallel import mesh as m
    from raytrace_tpu_torch.parallel.multihost import replicate_to_mesh
    from raytrace_tpu_torch.scene.procedural import make_sphere_field

    mesh = _mesh()
    r = mesh.rank
    mine = torch.arange(3, dtype=torch.float64) + 10 * r
    scene = make_sphere_field(2, device="cpu")
    if r:  # the other ranks' scenes differ from rank 0's
        scene.data.prim_p.add_(r)
    return {
        "ranks": mesh.ranks, "rank": r, "shape": mesh.shape,
        "shape_2d": [m.make_mesh_2d(d, device="cpu").shape
                     for d in (None, 2, mesh.ranks)],
        "gathered": torch.stack(m.all_gather(mine, mesh)),
        "summed": m.all_reduce_sum_(mine.clone(), mesh),
        "broadcast": m.broadcast_(mine.clone(), mesh),
        "shifted": m.ring_shift([mine, mine.to(torch.int32)], mesh),
        "replicated": replicate_to_mesh(scene.data, mesh).prim_p,
    }


def ring_radiance_job(scene, lanes, seed):
    """Rank r's lanes ``lanes[r]`` through the ring's round loop with
    the plain twin as its step: their radiance (3, N), and the live lanes
    of this rank at each round the rank took."""
    import torch

    from raytrace_tpu_torch.ops import intersect
    from raytrace_tpu_torch.parallel import ring
    from raytrace_tpu_torch.render import ring_shade

    mesh = _mesh()
    ref = ring_shade.ring_shade_reference
    live = []

    def finish(data, spec, state, *answers):
        live.append(int(state.live.sum()))
        ref.finish(data, spec, state, *answers)

    step = ref._replace(finish=finish)
    with ring.ring_context(scene.data, scene.spec, mesh) as stripped:
        acc = ring.ring_radiance(intersect.ring_ctx(), stripped, scene.spec,
                                 *lanes[mesh.rank], seed, step=step)
    return torch.stack(list(acc)), live


def grads_of(make_loss):
    """The gradients of one of ``chip_smoke.grad_losses``' paths:
    ``make_loss() -> (loss, leaves)``, then ``backward()``."""
    loss, leaves = make_loss()
    loss.backward()
    return [x.grad for x in leaves]


def ring_grad_job(data, spec, ro, rd, mesh=None):
    """``make_ring_intersector``'s gradients of one loss
    (``chip_smoke.t_loss``) that every rank takes of the gathered result:
    prim_p, prim_q, ro, rd (``mesh`` by default the group's, on the
    CPU)."""
    return grads_of(grad_losses(data, spec, ro, rd, mesh or _mesh())["t"])


def ring_rec_grad_job(data, spec, ro, rd, mesh=None):
    """Rank r's slice of the rays through ``ring_closest_hit`` under a ring
    context, a loss of its records (``chip_smoke.rec_loss``),
    ``backward()`` on every rank: each per-object leaf's gradient."""
    from raytrace_tpu_torch.parallel.ring import OBJECT_LEAVES

    return dict(zip(OBJECT_LEAVES, grads_of(grad_losses(
        data, spec, ro, rd, mesh or _mesh())["records"])))


class _Stop(Exception):
    """Raised from a render's progress to stop it, as a kill would."""


def checkpoint_job(kind, scene, spp, paths, steps):
    """Rank r's renders of ``scene`` through ``render_image_sharded``
    (``kind`` "sharded") or ``render_image_ring`` ("ring"), one sample
    chunk a launch group, with the checkpoint at ``paths[r]``: for each
    ``(seed, checkpointed, stop)`` of ``steps``, ``("image", image)``,
    ``("stopped", fractions)`` when ``stop`` and progress passed half way
    (after the second group, before its checkpoint write), or
    ``("refused", message)`` on a ``ValueError``."""
    from raytrace_tpu_torch.parallel.ring import render_image_ring
    from raytrace_tpu_torch.parallel.tile import render_image_sharded
    from raytrace_tpu_torch.render import integrator

    integrator._group_cap = lambda *args: 1   # one chunk a group
    render = {"sharded": render_image_sharded, "ring": render_image_ring}[kind]
    mesh = _mesh()
    out = []
    for seed, checkpointed, stop in steps:
        fractions = []

        def progress(frac):
            fractions.append(frac)
            if stop and frac >= 0.5:
                raise _Stop

        try:
            out.append(("image", render(
                scene, seed=seed, spp=spp, mesh=mesh, max_lanes=8,
                progress=progress,
                checkpoint=paths[mesh.rank] if checkpointed else None)))
        except _Stop:
            out.append(("stopped", fractions))
        except ValueError as e:
            out.append(("refused", str(e)))
    return out


def _printing(fn, *args, **kwargs):
    """(``fn(*args, **kwargs)``, what it printed)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kwargs)
    return res, out.getvalue()


def bench_shard_job(argv, ks, reps):
    """``raytrace_tpu_torch.bench.main(argv)`` on every rank (its
    ``--shard`` mode, the group already joined): (exit code, what the rank
    printed)."""
    from raytrace_tpu_torch import bench

    return _printing(bench.main, argv, ks=ks, reps=reps)


def dryrun_job(n):
    """``raytrace_tpu_torch.entry.dryrun_multichip(n)`` on the CPU: its
    result and the line it printed."""
    from raytrace_tpu_torch.entry import dryrun_multichip

    return _printing(dryrun_multichip, n, device="cpu")
