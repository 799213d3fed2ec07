"""What a cell's window drives: the port's requests, one kind of traffic
each, and the check of what they produced against the reference.

``render`` traffic: a request is the CLI's ``render_image`` (default
``max_lanes``), then the CLI's clip and encode, kept in memory: the
port's native sRGB encoder (``io.native.encode_srgb_native``, the C++ of
``raytrace_tpu_torch/csrc/srgb_encode.cpp`` that the CLI's
``write_bmp_native`` runs) where its library loads or builds, else
``color.to_srgb``, as the CLI falls back; then the BMP's header and
rows.  ``fit`` traffic: a step is
``optim.fit``'s loop body, ``loss_and_grad`` over every float leaf and
Adam's step, ending when the loss is on the host.  Both loops are closed,
with one client: each request starts when the last one has finished, with
a fresh seed drawn from the run's seed.

Only this module calls into the port (``raytrace_tpu_torch``); the check
computes everything again with the configuration's reference
(``bench.reference``, resolved by :mod:`benchmark.manifest`), a fit's
steps with ``benchmark.reference.fit``.  Other kinds of traffic live in
``benchmark/kinds/``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchmark.reference import encode as ref_encode
from benchmark.reference import fit as ref_fit


@dataclasses.dataclass
class Window:
    """The measured window: every request's seconds, the window's own
    seconds (from its start to the end of its last request), and the
    closest-hit rounds of the finished requests."""

    latencies: list = dataclasses.field(default_factory=list)
    encode_s: list = dataclasses.field(default_factory=list)
    encode_path: str | None = None
    elapsed: float = 0.0
    rays: int = 0
    traced: int = 0


def _rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream])


class Cell:
    """The shared part of a cell: its scene, sizes and streams of seeds."""

    def __init__(self, bench, device, spans):
        self.bench, self.device, self.spans = bench, device, spans
        cfg, traffic = bench.config, bench.traffic
        self.text = bench.scene_text
        self.reference, self.ref = bench.reference, bench.ref
        self.width = traffic.get("width") or cfg["width"]
        self.height = traffic.get("height") or cfg["height"]
        self.spp = traffic.get("samples") or cfg["samples"]
        self.seeds = _rng(bench.seed, 1)
        self.window = Window()

    def next_seed(self) -> int:
        return int(self.seeds.integers(0, 2 ** 31 - 1))

    def program_scene(self):
        from raytrace_tpu_torch.scene import dsl
        from raytrace_tpu_torch.scene.builder import build_scene

        sc = build_scene(dsl.parse(self.text), device=self.device)
        spec = dataclasses.replace(sc.spec, width=self.width,
                                   height=self.height)
        return dataclasses.replace(sc, spec=spec)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lanes(self) -> int:
        """Primary lanes of one request."""
        return self.width * self.height * self.spp

    def free(self):
        """Let go of the program's state before the check runs."""
        self.scene = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


class RenderCell(Cell):
    """Final renders and previews through the image loop."""

    def setup(self):
        self.scene = self.program_scene()
        self.kept = []                       # (seed, image, bmp) sampled
        self.pick = _rng(self.bench.seed, 2)
        self.request(self.next_seed(), keep=False)   # warm every shape

    def request(self, seed: int, keep: bool = True):
        from raytrace_tpu_torch import color
        from raytrace_tpu_torch.io import bmp, native
        from raytrace_tpu_torch.render.integrator import render_image

        spans = self.spans
        t0 = time.perf_counter()
        spans.enter("request")
        spans.enter("group")

        def progress(_frac):
            spans.exit("group")
            spans.enter("group")

        img = render_image(self.scene, seed=seed, spp=self.spp,
                           progress=progress)
        spans.exit("group")
        spans.enter("encode")
        t1 = time.perf_counter()
        clipped = np.clip(img, 0.0, None).astype(np.float32)
        srgb = native.encode_srgb_native(clipped)
        path = "native"
        if srgb is None:
            srgb = color.to_srgb(torch.from_numpy(clipped)).numpy()
            path = "torch"
        blob = bmp.header(self.width, self.height) + bmp.encode_rows(
            srgb).tobytes()
        t2 = time.perf_counter()
        spans.exit("encode")
        spans.exit("request")
        if keep:
            w = self.window
            w.latencies.append(t2 - t0)
            w.encode_s.append(t2 - t1)
            w.encode_path = path
            w.rays += self.reference.request_rays(self.ref, self.width,
                                                  self.height, self.spp)
            self._keep(len(w.latencies) - 1, (seed, img, blob))

    def _keep(self, i: int, item):
        """Reservoir sampling: every finished request has the same chance
        to be among the ``check_images`` kept for the check."""
        k = self.bench.traffic["check_images"]
        if i < k:
            self.kept.append(item)
        else:
            j = int(self.pick.integers(0, i + 1))
            if j < k:
                self.kept[j] = item

    def check(self, control=None) -> dict:
        """``pixel_gap``: the mean gap of the kept images' pixels, drawn
        from the seed, to the reference's over the same samples, over the
        reference's mean; ``bytes_off``: the BMP bytes that differ from
        the reference's encoding of the same image.  With ``control`` (a
        dtype) the reference in that precision stands in the program's
        place, and only the pixels are compared."""
        per_image = min(max(self.bench.config["check_lanes"] // self.spp, 1),
                        self.width * self.height)
        gap = ref_sum = 0.0
        off = 0
        draw = _rng(self.bench.seed, 3)
        ref_mod = self.reference
        lv = ref_mod.leaves(self.ref, self.device, torch.float32)
        low = (None if control is None
               else ref_mod.leaves(self.ref, self.device, control))

        def means(leaves, pix, seed):
            return ref_mod.pixel_means(
                self.ref, leaves, torch.as_tensor(pix, device=self.device),
                self.spp, seed, self.width, self.height,
                self.bench.config["check_block"]).cpu().numpy()

        for seed, img, blob in self.kept:
            pix = np.sort(draw.choice(self.width * self.height, per_image,
                                      replace=False))
            ref = means(lv, pix, seed)
            got = (img.reshape(-1, 3)[pix] if low is None
                   else means(low, pix, seed))
            gap += float(np.abs(got - ref).sum())
            ref_sum += float(np.abs(ref).sum())
            want = ref_encode.bmp_bytes(img)
            off += (int(np.count_nonzero(np.frombuffer(blob, np.uint8)
                                         != np.frombuffer(want, np.uint8)))
                    if len(blob) == len(want) else len(want))
        out = {"pixel_gap": gap / ref_sum if ref_sum else float("inf")}
        if low is None:
            out["bytes_off"] = off
        return out


class FitCell(Cell):
    """Fitting steps: the scene, perturbed from the seed, fitted to the
    reference's render of the unperturbed scene."""

    def setup(self):
        t = self.bench.traffic
        self.lr = t["learning_rate"]
        self.noise = ref_fit.perturbation(self.ref, _rng(self.bench.seed, 4),
                                          t["perturb"])
        n = self.width * self.height
        pix = torch.arange(n, dtype=torch.int64, device=self.device)
        self.px, self.py = pix % self.width, pix // self.width
        # the target: the reference's render of the unperturbed scene
        lv = self.reference.leaves(self.ref, self.device, torch.float32)
        self.target = self.reference.pixel_means(
            self.ref, lv, pix, t["target_samples"], self.next_seed(),
            self.width, self.height, self.bench.config["check_block"]).to(
                torch.float32)
        del lv
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        self.fit_seed = self.next_seed()
        self.scene = self.program_scene()
        from raytrace_tpu_torch.scene.schema import SceneData

        self.SceneData = SceneData
        leaves = {f.name: getattr(self.scene.data, f.name).detach().clone()
                  for f in dataclasses.fields(SceneData)}
        for name, delta in self.noise.items():
            leaves[name] = leaves[name] + torch.as_tensor(
                delta, dtype=leaves[name].dtype, device=self.device)
        self.leaves = leaves
        self.trained = [n for n, v in leaves.items() if v.is_floating_point()]
        self.mask = SceneData(**{n: n in self.trained for n in leaves})
        self.opt = torch.optim.Adam([leaves[n] for n in self.trained],
                                    lr=self.lr)
        self.sample_ids = torch.arange(self.spp, dtype=torch.int64,
                                       device=self.device)
        self.step_no = 0
        # the first steps, which the reference follows
        self.start = {n: v.detach().clone() for n, v in leaves.items()}
        self.losses = []
        for i in range(ref_fit.STEPS):
            self.losses.append(self.step())
            if i == 0:
                # the gradient as Adam got it: its first moment after one
                # step is (1 - beta1) times the gradient (none: no step)
                beta1 = self.opt.defaults["betas"][0]
                self.grad0 = {n: (self.opt.state[leaves[n]].get(
                    "exp_avg", torch.zeros_like(leaves[n]))
                    / (1.0 - beta1)).detach().clone()
                    for n in self.trained}
        self.change = {n: (leaves[n] - self.start[n]).detach().clone()
                       for n in self.trained}

    def step(self) -> float:
        from raytrace_tpu_torch import optim

        spans = self.spans
        leaves = self.leaves
        spans.enter("loss_and_grad")
        loss, grads = optim.loss_and_grad(
            self.SceneData(**leaves), self.scene.spec, self.px, self.py,
            self.sample_ids, self.fit_seed + self.step_no, self.target,
            self.mask)
        spans.exit("loss_and_grad")
        spans.enter("optimiser")
        for n in self.trained:
            leaves[n].grad = getattr(grads, n)
        self.opt.step()
        spans.exit("optimiser")
        spans.enter("fetch")
        out = float(loss)
        spans.exit("fetch")
        self.step_no += 1
        return out

    def request(self, seed: int, keep: bool = True):
        """One step; its seed is the fit's plus the step's number, as
        ``optim.fit`` varies it, so ``seed`` goes unused."""
        t0 = time.perf_counter()
        self.spans.enter("step")
        self.step()
        self.spans.exit("step")
        if keep:
            self.window.latencies.append(time.perf_counter() - t0)

    def free(self):
        self.opt = self.leaves = self.start = None
        super().free()

    def check(self, control=None) -> dict:
        """The first steps' losses, first gradient and change against the
        reference's; with ``control`` (a dtype) the reference in that
        precision stands in the program's place."""
        def replay(dtype):
            return ref_fit.replay(self.ref, self.noise, self.target, self.px,
                                  self.py, self.fit_seed, self.lr, self.width,
                                  self.height, dtype)

        got = ({"losses": self.losses, "grad0": self.grad0,
                "change": self.change} if control is None
               else replay(control))
        return ref_fit.compare(got, replay(torch.float32))


KINDS = {"render": RenderCell, "fit": FitCell}
