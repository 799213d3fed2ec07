"""The lit tree reference (``reference/tree_lit.py``) reads the showcase
(three lights, a depth-of-field camera of four lens samples, all four
materials) as the port does, agrees with the port's plain path there and,
on the card, with K3's small instance, refuses what it does not
implement, imports nothing of the port, and judges ``showcase.final``
through ``manifest.load`` from a copy of the benchmark; the check catches
a light dropped, one lens sample for four, the shadow rays ignored and the
area light drawing from another light's stream."""

from __future__ import annotations

import dataclasses
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import manifest, program_spans, scenes
from benchmark.reference import tree, tree_lit
from benchmark.tests.test_harness_faults import _correct
from benchmark.tests.test_harness_reference import _loaded_after
from benchmark.tests.test_harness_reference_tree import (  # noqa: F401
    REFUSED, _example, _port, copied)
from benchmark.trace import Op, Trace
from benchmark.yardstick import counts, lit
from raytrace_tpu_torch.models import materials
from raytrace_tpu_torch.ops import rng as port_rng
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.scene.schema import LIGHT_AREA
from raytrace_tpu_torch.utils.profiling import Record

ROOT = manifest.ROOT
SEED = 2 ** 31 + 13
CELL = "showcase.final"
SHOWCASE = _example("materials_showcase.txt")
# the port's small size: 32x20 pixels, 2 samples x 4 lens samples
W, H, SPP = 32, 20, 2
# the image's tolerance.  The lanes are the port's plain path's, but for
# an ulp on a few: torch.pow on the CPU rounds some inputs one ulp apart
# in its vectorized body and in its scalar tail, and the two walks put a
# lane in different places of their batches.  The port's image is a
# float32 mean of each launch's lanes summed in float64, the reference's a
# float64 mean: rtol 1e-6 holds both, and atol 1e-9 the pixels near 0.
RTOL, ATOL = 1e-6, 1e-9


def test_reads_the_showcase():
    """The showcase's spec: depth 4, 4 lens samples, 3 lights; its tree:
    four slots, two children a node, 63 nodes; a request's rays at
    640x400x256; its numbers the port's scene's leaves."""
    ref = tree_lit.parse(SHOWCASE)
    spec = tree_lit.spec(ref)
    assert (spec.max_depth, spec.cam_samples, spec.n_lights) == (4, 4, 3)
    assert spec.cam_type == 1 and spec.n_indirect == 2
    assert (ref.children_per_ray, ref.fan_out) == (4, 2)
    assert tree.nodes(ref) == 63
    assert tree_lit.request_rays(ref, 640, 400, 256) == 16_515_072_000
    sc = _port(SHOWCASE, 640, 400)
    assert sc.spec.light_type == ref.light_kind
    assert (sc.spec.cam_samples, sc.spec.max_live_children,
            sc.spec.children_per_ray) == (4, 2, 4)
    for name, want in ref.arrays.items():
        got = getattr(sc.data, name).double().numpy()
        np.testing.assert_array_equal(got, np.float32(want), err_msg=name)


LOOK_AT = SHOWCASE.replace(
    "new((0, 0.6, 0), (0, -0.12, -1), (0, 1, 0), 2.4)",
    "look_at((0, 0.6, -5), (0, -0.12, -1), (0, 1, 0), 40, 2.4)")
LIT_REFUSED = {
    "skybox": REFUSED["skybox"],
    "glossy_indirect": REFUSED["glossy_indirect"],
    "look_at": (LOOK_AT, "depth-of-field camera wraps new"),
    "spot": (SHOWCASE.replace("PointLight", "SpotLight"), "SpotLight"),
}


@pytest.mark.parametrize("case", sorted(LIT_REFUSED))
def test_parse_refuses(case):
    text, word = LIT_REFUSED[case]
    assert text != SHOWCASE
    with pytest.raises(ValueError, match=word):
        tree_lit.parse(text)


def test_tree_lit_imports_nothing_of_the_port():
    top = _loaded_after("import benchmark.reference.tree_lit, "
                        "benchmark.reference.tree_lit_scene, "
                        "benchmark.yardstick.lit")
    assert not {"raytrace_tpu", "raytrace_tpu_torch", "jax"} & set(top)


def test_cell_dispatches_from_a_copy(copied):
    """``showcase.final`` resolves, from a copied tree, to that tree's
    ``reference/tree_lit.py``, whose answers the harness takes."""
    b = manifest.load(CELL, SEED, root=str(copied))
    assert b.reference.__file__ == str(copied / "benchmark" / "reference"
                                       / "tree_lit.py")
    assert b.config["reference"] == "tree_lit"
    assert b.scene_text == SHOWCASE
    assert b.reference.n_objects(b.ref) == b.config["objects"] == 4
    assert b.reference.request_rays(b.ref, 640, 400, 256) == 16_515_072_000
    spec = b.reference.spec(b.ref)
    assert (spec.max_depth, spec.cam_samples, spec.n_lights) == (4, 4, 3)
    assert set(b.limits) == {"pixel_gap", "bytes_off"}
    assert {m["name"] for m in b.per_layer} == {
        "k3_roofline", "glue_share.final", "device_idle.final",
        "srgb_encode_ms.final", "fetch_mb.final"}
    assert {m["name"] for m in b.end_to_end} == {"rays_per_s",
                                                 "image_s_p95", "setup_s"}


@pytest.mark.parametrize("seed", [SEED, 77])
def test_lanes_agree(seed):
    """Each of 4,096 lanes (pixel, sample, lens sample) is the port's plain
    path's within two ulps, and all but a few to the bit."""
    sc = _port(SHOWCASE, W, H)
    ref = tree_lit.parse(SHOWCASE)
    lv = tree_lit.leaves(ref, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    lanes = [torch.randint(0, k, (4096,), generator=g) for k in (W, H, 8, 4)]
    want = torch.stack(tuple(megakernel.radiance_lanes(
        sc.data, sc.spec, *lanes, seed)), 1)
    got = tree_lit.walk(ref, lv, *lanes, seed, W, H)
    assert int((got != want).any(dim=1).sum()) <= 8
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


def _images(seed, device):
    """The port's render at 32x20x2x4 and the reference's means, float32,
    and the reference's in bfloat16, on ``device``."""
    sc = _port(SHOWCASE, W, H)
    sc = dataclasses.replace(sc, data=sc.data.to(device))
    img = render_image(sc, seed=seed, spp=SPP).reshape(-1, 3)
    ref = tree_lit.parse(SHOWCASE)
    pix = torch.arange(W * H, device=device)

    def means(dtype):
        return tree_lit.pixel_means(ref, tree_lit.leaves(ref, device, dtype),
                                    pix, SPP, seed, W, H, 1 << 12
                                    ).cpu().numpy()
    return img, means(torch.float32), means(torch.bfloat16)


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
def test_image_agrees(seed):
    """``render_image`` on CPU tensors (the kernels' plain version) against
    the reference's pixel means, within the tolerance above, which the
    reference in bfloat16 fails."""
    img, means, low = _images(seed, torch.device("cpu"))
    np.testing.assert_allclose(img, means, rtol=RTOL, atol=ATOL)
    assert not np.allclose(low, means, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
def test_image_agrees_on_the_card(card, seed):
    """K3's small instance (the showcase takes the 8-entry stack, the scene
    in shared memory) against the reference on the card at the same size,
    by the cell's own number: Σ|program − reference| / Σ|reference| within
    the cell's ``pixel_gap`` limit, which the reference in bfloat16
    exceeds."""
    with open(os.path.join(ROOT, "benchmark", "limits", f"{CELL}.json")) as f:
        limit = json.load(f)["pixel_gap"]
    sc = _port(SHOWCASE, W, H)
    assert megakernel.launch_counts(sc.spec, 1)["stack"] == 8
    img, means, low = _images(seed, card)
    assert np.abs(img - means).sum() / np.abs(means).sum() <= limit
    assert np.abs(low - means).sum() / np.abs(means).sum() > limit


@pytest.fixture
def small_showcase(small_cell):
    """``showcase.final`` at 16x16 pixels, 8 samples x 4 lens samples."""
    return small_cell(CELL)


def test_sound_run_is_correct(small_showcase):
    ok, checks = _correct(small_showcase)
    assert ok, checks


def _light_dropped(monkeypatch):
    """The scene's last light (the area light) left out of every launch."""
    real = integrator.sample_pixels

    def dropped(data, spec, *a, **k):
        spec = dataclasses.replace(spec, light_type=spec.light_type[:-1])
        return real(data, spec, *a, **k)
    monkeypatch.setattr(integrator, "sample_pixels", dropped)


def _one_lens_sample(monkeypatch):
    """Each sample's first lens sample alone, for the camera's four."""
    real = integrator.sample_pixels

    def one(data, spec, *a, **k):
        return real(data, dataclasses.replace(spec, cam_samples=1), *a, **k)
    monkeypatch.setattr(integrator, "sample_pixels", one)


def _shadows_ignored(monkeypatch):
    """No shadow ray is ever blocked."""
    monkeypatch.setattr(materials, "occluded_v",
                        lambda data, spec, ro, *a: torch.zeros_like(
                            ro.x, dtype=torch.bool))


def _area_stream(monkeypatch):
    """The area light draws under light 0's purposes, the point light's,
    not its own."""
    sc = _port(SHOWCASE, W, H)
    li = sc.spec.light_type.index(LIGHT_AREA)
    assert li > 0
    monkeypatch.setattr(port_rng, "PURPOSE_LIGHT_U",
                        port_rng.PURPOSE_LIGHT_U - 2 * li)
    monkeypatch.setattr(port_rng, "PURPOSE_LIGHT_V",
                        port_rng.PURPOSE_LIGHT_V - 2 * li)


@pytest.mark.parametrize("fault", [_light_dropped, _one_lens_sample,
                                   _shadows_ignored, _area_stream])
def test_lit_fault_is_caught(small_showcase, monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _correct(small_showcase)
    assert not ok, checks


@pytest.mark.parametrize("n", [40, 100])
def test_walk_without_lights_is_the_tree_walk(n):
    """On a mixed field (no lights, a pinhole camera, lens sample 0) the
    lit walk is ``tree.walk`` to the bit, and its work ``tree.work``'s,
    with no shadow ray."""
    text = scenes.sphere_field(n, width=12, height=10, mix_materials=True,
                               seed=4)
    lit, plain = tree_lit.parse(text), tree.parse(text)
    lv = tree_lit.leaves(lit, "cpu", torch.float32)
    g = torch.Generator().manual_seed(n)
    lanes = [torch.randint(0, k, (256,), generator=g) for k in (12, 10, 4)]
    got = tree_lit.walk(lit, lv, *lanes, torch.zeros_like(lanes[0]), 91,
                        12, 10)
    assert torch.equal(got, tree.walk(plain, tree.leaves(plain, "cpu",
                                                         torch.float32),
                                      *lanes, 91, 12, 10))
    want = tree.work(plain, lv, lanes, 91, 12, 10, large=n > 64)
    work = tree_lit.work(lit, lv, lanes, 91, 12, 10, large=n > 64)
    assert work == dict(want, shadow=0.0, shadow_spheres=0.0,
                        shadow_planes=0.0)


def test_showcase_work():
    """On the showcase each lane (of 64 (pixel, sample) lanes, each with its
    four lens samples) casts three shadow rays at most at each hit above
    the last level, each testing the floor, the first object, and at most
    the three spheres after it."""
    ref = tree_lit.parse(SHOWCASE)
    lv = tree_lit.leaves(ref, "cpu", torch.float32)
    g = torch.Generator().manual_seed(8)
    lanes = [torch.randint(0, k, (64,), generator=g) for k in (W, H, 8)]
    w = tree_lit.work(ref, lv, lanes, 5, W, H, large=False)
    assert w["visits"] > 1 + w["last_hits"]          # the tree fans out
    assert 0 < w["shadow"] <= 3 * (w["hits"] - w["last_hits"])
    tests = w["shadow_spheres"] + w["shadow_planes"]
    assert w["shadow"] <= tests <= 4 * w["shadow"]
    assert w["shadow_planes"] == w["shadow"]     # the floor, tested first


LIT_WORK = {"visits": 9.5, "hits": 8.0, "last_hits": 1.5, "misses": 0.0,
            "chunks": 0.0, "shadow": 12.0, "shadow_spheres": 30.0,
            "shadow_planes": 11.0}
LIT_SPEC = types.SimpleNamespace(shape_type=(1, 0, 0, 0), n_lights=3,
                                 cam_samples=4)


def test_lit_counts():
    """The closest-hit tests and bytes of ``render_counts``, the shadow
    rays' tests at 28 operations a sphere and 14 a plane, and each light's
    64-byte row."""
    flops, nbytes = lit.lit_counts(LIT_SPEC, 1000, LIT_WORK)
    assert flops == 1000 * (9.5 * (3 * 28 + 14) + 30 * 28 + 11 * 14)
    assert nbytes == 28 * 1000 + 96 * 4 + 64 * 3
    assert lit.lit_bound(LIT_SPEC, 1000, LIT_WORK) == counts.bound(flops,
                                                                   nbytes)


def _lit_run(monkeypatch, span_counts, large=False):
    """A traced run of one request of two launches (1 ms and 3 ms on the
    device), each wrapper span counting ``span_counts[j]``."""
    root = Record("image_loop", 0, None, 0, 9_000, {})
    records, ops = [root], []
    for j, c in enumerate(span_counts):
        records.append(Record("megakernel_tree", len(records), 0, 100 + j,
                              200 + j, c))
        ops.append(Op("void megakernel_tree<8, 0, false>(Params)",
                      1000 * j, 1000 * j + 1000 + 2000 * j))
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    return types.SimpleNamespace(
        trace=Trace(ops, [], [], (0.0, 10_000.0)),
        launches={"megakernel_tree": 2}, large=large, spec=LIT_SPEC,
        window=types.SimpleNamespace(traced=1),
        work=lambda: LIT_WORK, traced_lanes=lambda: 1_000_000)


INSTANCE = {"stack": 8, "large": 0, "lights": 3, "lens": 4}


@pytest.mark.parametrize("span_counts, lanes", [
    # this program's spans: each launch's lanes, its instance the scene's
    ([dict(INSTANCE, lanes=4_096_000), dict(INSTANCE, lanes=1_024_000)],
     (4_096_000, 1_024_000)),
    # a program whose spans count the lanes and not the lights or lens
    ([{"lanes": 4_096_000, "stack": 8, "large": 0}] * 2, (4_096_000,) * 2),
    # a program whose spans count nothing: the traced lanes, each with its
    # four lens samples, shared evenly
    ([{}, {}], (2_000_000,) * 2),
])
def test_k3_roofline_reads_the_spans(monkeypatch, span_counts, lanes):
    read = manifest.reader("k3_roofline")
    run = _lit_run(monkeypatch, span_counts)
    want = 100.0 * sum(lit.lit_bound(LIT_SPEC, n, LIT_WORK)[0]
                       for n in lanes) / 4.0
    assert read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < read(run) < 100


@pytest.mark.parametrize("fault", ["large", "lights", "lens", "lost"])
def test_k3_roofline_refuses(monkeypatch, fault):
    """None on a large scene, on a launch whose span names another
    instance (K3-large, no lights, one lens sample), and where the trace
    lost a launch."""
    span = dict(INSTANCE, lanes=4_096_000)
    if fault in ("lights", "lens"):
        span[fault] = {"lights": 0, "lens": 1}[fault]
    if fault == "large":
        span["large"] = 1
    run = _lit_run(monkeypatch, [dict(INSTANCE, lanes=4_096_000), span],
                   large=fault == "large")
    if fault == "lost":
        run.launches = {"megakernel_tree": 3}
    assert manifest.reader("k3_roofline")(run) is None
