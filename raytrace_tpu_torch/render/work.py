"""What a launch's paths need of the render kernels, counted by walking
the plain version: live nodes per lane and per warp, skybox lookups, and
for a large scene the sphere chunks that the rays enter, per lane and as
the union over a warp.  ``utils/flops.py`` makes the kernels' bounds from
these counts, and ``chip_smoke.py`` prints them beside the kernels'
times; nothing on the render path calls this module.
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace_tpu_torch.ops import intersect_scan
from raytrace_tpu_torch.ops.intersect import closest_hit, scene_tables
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.render.integrator import (_dfs_schedule, primary_rays,
                                                  tree_loop_entry,
                                                  tree_loop_node,
                                                  tree_loop_stack)
from raytrace_tpu_torch.scene.schema import BG_SKYBOX, SceneData, SceneSpec

WARP = 32


def warp_sample(t: torch.Tensor, n_warps: int = 512) -> torch.Tensor:
    """``n_warps`` whole warps of ``t`` (32 consecutive elements each, as a
    launch hands them to its threads), drawn without replacement from a
    fixed seed and kept in order: the same warps for every tensor of one
    length.  An even stride would not do: in a pixel-ordered launch it
    falls into step with the image's width and samples a few columns.  A
    ragged tail is left out."""
    warps = t[:t.shape[0] // WARP * WARP].reshape(-1, WARP)
    if warps.shape[0] <= n_warps:
        return warps.reshape(-1)
    pick = np.sort(np.random.RandomState(0).choice(warps.shape[0], n_warps,
                                                   replace=False))
    return warps[torch.from_numpy(pick).to(t.device)].reshape(-1)


def path_work(data: SceneData, spec: SceneSpec, lanes, seed: int) -> dict:
    """The work of these lanes' paths; their number must be a multiple of
    32, and each 32 consecutive ones count as a warp.  Returns

    * ``visits``: live nodes per lane (the nodes a live-only walk runs);
    * ``warp_visits``: the largest number of live nodes among a warp's
      lanes, averaged over the warps (the rounds a warp of the tree kernel
      takes);
    * ``most``: the largest number of live nodes of any lane (the rounds
      that the ring's walk, one node of every lane a round, takes over
      these lanes);
    * ``misses``: live nodes per lane whose ray hits nothing (each a
      skybox lookup in a skybox scene; 0 for a solid background);
    * ``hits``: live nodes per lane whose ray hits an object, and
      ``last_hits`` those of them at the last depth, which add their
      ambient color and nothing else;
    * ``chunks``: for a large scene, sphere chunks entered per lane, summed
      over its live nodes (the others are culled); else 0;
    * ``by_depth``: for a large scene, per depth of the tree ``(live lanes
      per lane, chunks a live lane enters, chunks in the union over a
      warp's live lanes)``, the union taken among the lanes at the same
      position of the tree and averaged over the warps that have a live
      lane there.

    A small scene is walked breadth first over the live nodes alone, each
    depth's in one batch (a 16-sample tree at max_depth 4 has 1,118,481
    nodes a lane, of which some 1,400 live); a large scene's warp unions
    are taken among the lanes at one position of the tree, so it is walked
    depth first over every position, live or not.  Shadow rays are not
    counted, so a bound made from this is a lower one."""
    n = lanes[0].shape[0]
    if n == 0 or n % WARP:
        raise ValueError(f"{n} lanes are not whole warps")
    ro, rd, k1, k2 = primary_rays(data, spec, *lanes, seed)
    one = torch.ones_like(ro.x)
    entry = tree_loop_entry(ro, rd, one, V3(one, one, one), one, k1, k2,
                            ro.x.dtype)
    walk = _tree_work if megakernel.is_large(spec) else _live_work
    per_lane, counts = walk(data, spec, entry, n)
    return {"visits": float(per_lane.sum()) / n,
            "warp_visits": float(per_lane.reshape(-1, WARP).amax(dim=1)
                                 .double().mean()),
            "most": int(per_lane.max()),
            **{k: v / n for k, v in counts.items() if k != "by_depth"},
            "by_depth": counts["by_depth"]}


def _live_work(data: SceneData, spec: SceneSpec, entry, n: int):
    """:func:`path_work`'s walk of a small scene: each depth's live nodes
    in one batch, their lanes carried beside them (children are a
    function of their node alone, whatever the order of the walk).
    Returns the live nodes per lane and the summed counts."""
    m, levels, _, _ = tree_loop_stack(spec)
    lane = torch.arange(n, device=entry[0].device)
    per_lane = torch.zeros(n, dtype=torch.int64, device=lane.device)
    misses = hits = last_hits = 0
    for depth in range(levels):
        live = entry[10] > 0.5
        entry, lane = tuple(c[live] for c in entry), lane[live]
        per_lane += torch.bincount(lane, minlength=n)
        hit = closest_hit(data, spec, V3(*entry[0:3]), V3(*entry[3:6])).hit
        hits += int(hit.sum())
        if spec.bg_type == BG_SKYBOX:
            misses += int((~hit).sum())
        if depth == levels - 1:
            last_hits += int(hit.sum())
            break
        _, virt = tree_loop_node(data, spec, m, entry, depth)
        if len(virt) < m:  # no child slot at all: the walk ends here
            break
        entry = tuple(torch.cat(parts) for parts in zip(*virt))
        lane = lane.repeat(len(virt))
    return per_lane, {"misses": misses, "hits": hits,
                      "last_hits": last_hits, "chunks": 0, "by_depth": {}}


def _tree_work(data: SceneData, spec: SceneSpec, entry, n: int):
    """:func:`path_work`'s walk of a large scene: the DFS over every
    position of the tree, the lanes at one position in one batch, the
    chunks each live ray enters and their union over a warp's lanes
    there.  Returns the live nodes per lane and the summed counts."""
    m, levels, _, cap = tree_loop_stack(spec)
    tb = scene_tables(data, spec)
    stack = [None] * cap
    stack[0] = entry
    per_lane = torch.zeros(n, dtype=torch.int64, device=entry[0].device)
    chunks = misses = hits = last_hits = 0
    depth_live = [0] * levels
    depth_chunks = [0] * levels
    depth_union = [0] * levels
    depth_warps = [0] * levels
    sp = 1
    for depth in _dfs_schedule(m, levels):
        sp -= 1
        e = stack[sp]
        live = e[10] > 0.5
        per_lane += live
        depth_live[depth] += int(live.sum())
        hit = closest_hit(data, spec, V3(*e[0:3]), V3(*e[3:6])).hit & live
        hits += int(hit.sum())
        if depth == levels - 1:
            last_hits += int(hit.sum())
        if spec.bg_type == BG_SKYBOX:
            misses += int((live & ~hit).sum())
        mask = intersect_scan.scan_hit_reference(
            tb.table, tb.ids, tb.n_sph_pad, V3(*e[0:3]), V3(*e[3:6]),
            tb.bounds, return_mask=True)[3] & live[:, None]
        entered = int(mask.sum())
        chunks += entered
        depth_chunks[depth] += entered
        depth_union[depth] += int(
            mask.reshape(n // WARP, WARP, -1).any(dim=1).sum())
        depth_warps[depth] += int(live.reshape(-1, WARP).any(dim=1).sum())
        _, virt = tree_loop_node(data, spec, m, e, depth)
        if depth < levels - 1:
            if len(virt) < m:  # no child slot at all: the walk ends here
                break
            for j, child in enumerate(virt):
                stack[sp + (m - 1 - j)] = child
            sp += m
    by_depth = {d: (depth_live[d] / n,
                    depth_chunks[d] / max(depth_live[d], 1),
                    depth_union[d] / max(depth_warps[d], 1))
                for d in range(levels) if depth_live[d]}
    return per_lane, {"misses": misses, "hits": hits,
                      "last_hits": last_hits, "chunks": chunks,
                      "by_depth": by_depth}
