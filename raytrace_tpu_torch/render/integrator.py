"""Linear-chain integrator and the image loop (raytrace.rs:261-276,
main.rs:39-59).

PyTorch counterpart of the linear regime of
:mod:`raytrace_tpu.render.integrator`.  A primary sample's path is a chain
of ``max_depth + 2`` closest-hit + shade rounds (depths 0..max_depth
shade fully and spawn, depth max_depth+1 is ambient/background only),
with per-lane throughput and liveness masks.  :func:`radiance_linear_v`
is the plain PyTorch version of the CUDA megakernel
(:mod:`raytrace_tpu_torch.render.megakernel`), and the CPU path.

The image loop accumulates on the device in plain Python loops,
checkpoints the float64 host accumulator after every sample chunk, and
refuses to resume a checkpoint written for another render config.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from raytrace_tpu_torch.models.backgrounds import background_color_v
from raytrace_tpu_torch.models.cameras import project
from raytrace_tpu_torch.models.materials import shade
from raytrace_tpu_torch.ops import rng, vec
from raytrace_tpu_torch.ops.intersect import closest_hit
from raytrace_tpu_torch.ops.vec import V3
from raytrace_tpu_torch.render import megakernel
from raytrace_tpu_torch.scene.schema import Scene, SceneData, SceneSpec


def radiance_linear_v(data: SceneData, spec: SceneSpec, ro: V3, rd: V3,
                      k1, k2) -> V3:
    """Radiance of chains that never fan out (``children_per_ray <= 1``).
    Elementwise over whatever lane shape ``ro.x`` has."""
    if spec.children_per_ray > 1:
        raise NotImplementedError(
            "fan-out scenes are not ported yet (ROADMAP item 9)")
    sig = torch.ones_like(ro.x)
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
                  seed: int) -> torch.Tensor:
    """Mean radiance of samples ``sample_ids`` (S,) for pixels (px, py)
    (P,) each, as a (P, 3) tensor (main.rs:45-55 x raytrace.rs:270-276).
    y counts from the bottom row.  Every lane goes through
    :func:`raytrace_tpu_torch.render.megakernel.radiance_lanes`."""
    p, s = px.shape[0], sample_ids.shape[0]
    c = spec.cam_samples
    # lane axis = (pixel, aa_sample, cam_sample), flattened
    pix = px.repeat_interleave(s * c)
    piy = py.repeat_interleave(s * c)
    aa = sample_ids.repeat_interleave(c).repeat(p)
    cam = torch.arange(c, dtype=torch.int64, device=px.device).repeat(p * s)
    rad = megakernel.radiance_lanes(data, spec, pix, piy, aa, cam, seed)
    return vec.pack(V3(*(r.reshape(p, s * c).mean(dim=1) for r in rad)))


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
            sids = torch.arange(s0 + i * s_launch, s0 + (i + 1) * s_launch,
                                dtype=torch.int64, device=px.device)
            tile = tile + sample_pixels(data, spec, pxt, pyt, sids, seed)
        out[off:off + p_launch] = tile / n_chunks
    return out


def _s_p_launch(spec: SceneSpec, aa: int, max_lanes: int):
    """(samples, pixels) per launch: fill the lane budget without
    exceeding it, taking more samples per launch for small images."""
    lane_budget = max(max_lanes // spec.cam_samples, 1)
    n_pix = spec.width * spec.height
    if n_pix <= lane_budget:
        return min(aa, max(lane_budget // n_pix, 1)), n_pix
    return 1, lane_budget


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


def _retry_launch(fn, *args, retries: int = 2):
    """Run a render launch, retrying transient runtime failures.  A
    launch is a pure function of (scene, pixel/sample identities), so a
    re-issue is safe.  The result is fetched to the host inside the
    guarded region, so asynchronous device failures surface here."""
    for attempt in range(retries + 1):
        try:
            return fn(*args).cpu()
        except RuntimeError as e:
            if attempt == retries or not _is_transient(e):
                raise
            print(f"[raytrace_tpu_torch] launch failed (attempt "
                  f"{attempt + 1}/{retries + 1}); retrying", file=sys.stderr)
            time.sleep(0.5 * (attempt + 1))


def _save_checkpoint(path: str, **arrays) -> None:
    """Atomic checkpoint write: temp file + ``os.replace``, so a kill
    mid-write never corrupts the resume state."""
    tmp = path + ".tmp"
    np.savez(tmp, **arrays)
    # np.savez appends .npz when the name has no extension
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def _image_loop(scene: Scene, *, seed: int, spp: int | None,
                max_lanes: int, progress, checkpoint: str | None,
                chunk_group: int = 32) -> np.ndarray:
    """Host loop over groups of sample chunks.  The float64 host
    accumulator is checkpointed after every group, so a killed render
    resumes at the last group boundary.  ``progress`` gets the completed
    fraction in [0, 1]."""
    data, spec = scene.data, scene.spec
    w, h = spec.width, spec.height
    aa = spp if spp is not None else max(spec.antialias, 1)
    s_launch, p_launch = _s_p_launch(spec, aa, max_lanes)

    image = np.zeros((h * w, 3), np.float64)
    s_done = 0
    if checkpoint is not None and os.path.exists(checkpoint):
        with np.load(checkpoint) as ck:
            if not (ck["width"] == w and ck["height"] == h
                    and ck["aa"] == aa and ck["seed"] == seed):
                raise ValueError(
                    f"checkpoint {checkpoint} was written for a different "
                    f"render config; refusing to mix")
            image = ck["image"]
            s_done = int(ck["s_done"])

    # a group's work is bounded so one launch group never runs for
    # minutes (the linear chain never widens the lane axis)
    work_per_chunk = h * w * s_launch * spec.cam_samples
    g_cap = max(min(chunk_group, (1 << 28) // max(work_per_chunk, 1)), 1)
    pix = torch.arange(h * w, dtype=torch.int64, device=data.device)
    px, py = pix % w, pix // w
    s0 = s_done
    while s0 < aa:
        rem = aa - s0
        if rem >= s_launch:
            g, sl = min(g_cap, rem // s_launch), s_launch
        else:
            g, sl = 1, rem          # ragged tail chunk
        n_s = g * sl
        out = _retry_launch(_render_chunks, data, spec, px, py, s0, sl, g,
                            seed, p_launch)
        image += out.numpy().astype(np.float64) * (n_s / aa)
        s0 += n_s
        if progress is not None:
            progress(s0 / aa)
        if checkpoint is not None:
            _save_checkpoint(checkpoint, image=image, s_done=s0,
                             width=w, height=h, aa=aa, seed=seed)
    return image.reshape(h, w, 3)


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
