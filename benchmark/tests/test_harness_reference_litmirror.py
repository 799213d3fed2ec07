"""``litmirror.final``: the lit mirror (``chip_smoke.py::LIT_MIRROR``, a
Phong mirror floor and sphere under two lights, a depth-of-field camera of
two lens samples) judged by the lit reference (``reference/tree_lit.py``),
whose walk with one child a node is the port's linear chain.  The cell
resolves from a copy of the benchmark with golden's rays a request; the
reference agrees with the port's plain path and, on the card, with K1's
lit instance; the check catches a light dropped, one lens sample for two,
the shadow rays ignored and the mirror's reflection cut short; the
yardstick ``yardstick/k1_lit.py`` and the reader ``k1_lit_roofline``
count what they say."""

from __future__ import annotations

import ast
import dataclasses
import inspect
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import manifest, program_spans
from benchmark.reference import linear, tree, tree_lit
from benchmark.tests.test_harness_faults import _correct
from benchmark.tests.test_harness_reference_tree import (  # noqa: F401
    _port, copied)
from benchmark.tests.test_harness_reference_tree_lit import (
    _light_dropped, _one_lens_sample, _shadows_ignored)
from benchmark.trace import Op, Trace
from benchmark.yardstick import counts, k1_lit, lit
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.render.integrator import render_image
from raytrace_tpu_torch.utils.profiling import Record

ROOT = manifest.ROOT
SEED = 2 ** 31 + 21
CELL = "litmirror.final"
CONFIG = os.path.join(ROOT, "benchmark", "configs")
with open(os.path.join(CONFIG, "litmirror.txt")) as _f:
    LIT_MIRROR = _f.read()
# the port's small size: 32x32 pixels, 4 samples x 2 lens samples
W, H, SPP = 32, 32, 4
# the image's tolerance, the showcase's (test_harness_reference_tree_lit):
# the lanes are the port's plain path's but for an ulp on a few, and the
# port's image is a float32 mean of each launch's lanes summed in float64,
# the reference's a float64 mean
RTOL, ATOL = 1e-6, 1e-9


def _smoke_scene() -> str:
    """``chip_smoke.py``'s ``LIT_MIRROR``, read from its source without
    running the script."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        module = ast.parse(f.read())
    for node in module.body:
        if (isinstance(node, ast.Assign)
                and getattr(node.targets[0], "id", None) == "LIT_MIRROR"):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py has no LIT_MIRROR")


def test_cell_dispatches_from_a_copy(copied):
    """``litmirror.final`` resolves, from a copied tree, to that tree's
    ``reference/tree_lit.py``: the lit mirror of ``chip_smoke.py`` as
    ``litmirror.txt`` holds it, its two objects, its spec, and a request's
    rays, golden's at 800x800x1024."""
    b = manifest.load(CELL, SEED, root=str(copied))
    assert b.reference.__file__ == str(copied / "benchmark" / "reference"
                                       / "tree_lit.py")
    assert b.config["reference"] == "tree_lit"
    assert b.scene_text == LIT_MIRROR == _smoke_scene() + "\n"
    assert b.reference.n_objects(b.ref) == b.config["objects"] == 2
    rays = b.reference.request_rays(b.ref, 800, 800, 512)
    golden = linear.parse(open(os.path.join(CONFIG, "golden.txt")).read())
    assert rays == 3_932_160_000 == linear.request_rays(golden, 800, 800,
                                                        1024)
    spec = b.reference.spec(b.ref)
    assert (spec.max_depth, spec.cam_samples, spec.n_lights) == (4, 2, 2)
    assert (b.ref.fan_out, tree.nodes(b.ref)) == (1, 6)
    assert (b.config["width"], b.config["height"], b.config["samples"]) == (
        800, 800, 512)
    assert set(b.limits) == {"pixel_gap", "bytes_off"}
    assert b.limits["bytes_off"] == 0
    assert {m["name"] for m in b.per_layer} == {
        "k1_lit_roofline", "glue_share.final", "device_idle.final",
        "srgb_encode_ms.final", "fetch_mb.final"}
    assert {m["name"] for m in b.end_to_end} == {"rays_per_s",
                                                 "image_s_p95", "setup_s"}


def test_port_takes_the_lit_linear_instance():
    """The port renders the lit mirror with K1, its launches counting the
    instance that ``k1_lit_roofline`` asks for, in golden's launches: 3
    samples x 2 lens samples of every pixel, 3,840,000 lanes."""
    sc = _port(LIT_MIRROR, 800, 800)
    assert megakernel.kernel_for(sc.spec) == megakernel.KERNEL_LINEAR
    assert megakernel.launch_counts(sc.spec, 96) == {
        "lanes": 96, "large": 0, "lights": 2, "lens": 2}
    budget = inspect.signature(render_image).parameters["max_lanes"].default
    s, p = integrator._s_p_launch(sc.spec, 512, budget)
    assert s * p * sc.spec.cam_samples == 3_840_000
    gold = _port(open(os.path.join(CONFIG, "golden.txt")).read(), 800, 800)
    sg, pg = integrator._s_p_launch(gold.spec, 1024, budget)
    assert (s * p * 2, integrator._group_cap(sc.spec, s)) == (
        sg * pg, integrator._group_cap(gold.spec, sg))


@pytest.mark.parametrize("seed", [SEED, 77])
def test_lanes_agree(seed):
    """Each of 4,096 lanes (pixel, sample, lens sample) is the port's plain
    path's within two ulps, and all but a few to the bit."""
    sc = _port(LIT_MIRROR, W, H)
    ref = tree_lit.parse(LIT_MIRROR)
    lv = tree_lit.leaves(ref, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    lanes = [torch.randint(0, k, (4096,), generator=g) for k in (W, H, 8, 2)]
    want = torch.stack(tuple(megakernel.radiance_lanes(
        sc.data, sc.spec, *lanes, seed)), 1)
    got = tree_lit.walk(ref, lv, *lanes, seed, W, H)
    assert int((got != want).any(dim=1).sum()) <= 16
    np.testing.assert_allclose(got, want, rtol=2.5e-7, atol=0)


def _images(seed, device):
    """The port's render at 32x32x4x2 and the reference's means, float32,
    and the reference's in bfloat16, on ``device``."""
    sc = _port(LIT_MIRROR, W, H)
    sc = dataclasses.replace(sc, data=sc.data.to(device))
    img = render_image(sc, seed=seed, spp=SPP).reshape(-1, 3)
    ref = tree_lit.parse(LIT_MIRROR)
    pix = torch.arange(W * H, device=device)

    def means(dtype):
        return tree_lit.pixel_means(ref, tree_lit.leaves(ref, device, dtype),
                                    pix, SPP, seed, W, H, 1 << 12
                                    ).cpu().numpy()
    return img, means(torch.float32), means(torch.bfloat16)


@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
def test_image_agrees(seed):
    """``render_image`` on CPU tensors (the kernels' plain version) against
    the reference's pixel means, within the showcase's tolerance, which
    the reference in bfloat16 fails."""
    img, means, low = _images(seed, torch.device("cpu"))
    np.testing.assert_allclose(img, means, rtol=RTOL, atol=ATOL)
    assert not np.allclose(low, means, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [SEED, 2 ** 31 + 5])
def test_image_agrees_on_the_card(card, seed):
    """K1's lit instance against the reference on the card at the same
    size, by the cell's own number: Σ|program − reference| / Σ|reference|
    within the cell's ``pixel_gap`` limit, which the reference in bfloat16
    exceeds."""
    with open(os.path.join(ROOT, "benchmark", "limits", f"{CELL}.json")) as f:
        limit = json.load(f)["pixel_gap"]
    sc = _port(LIT_MIRROR, W, H)
    assert megakernel.kernel_for(sc.spec) == megakernel.KERNEL_LINEAR
    img, means, low = _images(seed, card)
    assert np.abs(img - means).sum() / np.abs(means).sum() <= limit
    assert np.abs(low - means).sum() / np.abs(means).sum() > limit


@pytest.fixture
def small_mirror(small_cell):
    """``litmirror.final`` at 16x16 pixels, 8 samples x 2 lens samples."""
    return small_cell(CELL)


def test_sound_run_is_correct(small_mirror):
    ok, checks = _correct(small_mirror)
    assert ok, checks


def _reflection_cut(monkeypatch):
    """The mirror's reflected ray followed from the first hit only: a hit
    after it spawns no child."""
    real = integrator.shade

    def cut(*a, **k):
        emit, children = real(*a, **k)
        return emit, (children if a[-1] == 0 else [])
    monkeypatch.setattr(integrator, "shade", cut)


@pytest.mark.parametrize("fault", [_light_dropped, _one_lens_sample,
                                   _shadows_ignored, _reflection_cut])
def test_lit_fault_is_caught(small_mirror, monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _correct(small_mirror)
    assert not ok, checks


def _mirror_work(n=16384, seed=9):
    """The lit reference's work on ``n`` lanes of the cell's 800x800
    image, each with both lens samples."""
    ref = tree_lit.parse(LIT_MIRROR)
    lv = tree_lit.leaves(ref, "cpu", torch.float32)
    g = torch.Generator().manual_seed(seed)
    pix = torch.randint(0, 800 * 800, (n,), generator=g)
    lanes = (pix % 800, pix // 800, torch.randint(0, 512, (n,), generator=g))
    return tree_lit.spec(ref), tree_lit.work(ref, lv, lanes, 31, 800, 800,
                                             large=False)


def test_k1_lit_bound_on_the_mirror():
    """On the lit mirror's work a launch of 2,097,152 lanes is bound at
    0.0263 ms by the integer unit (the hashes); without the shadow rays'
    tests the bound is ``counts.k1_bound``'s, operations and all."""
    spec, w = _mirror_work()
    assert 1.8 < w["shadow"] < 2.0 and w["misses"] == 0.0
    ms, by, units = k1_lit.k1_lit_bound(spec, 2_097_152, w)
    assert (round(ms, 4), by, max(units, key=units.get)) == (
        0.0263, "operations", "int32")
    assert units["fp32"] > counts.k1_bound(spec, 2_097_152, w)[2]["fp32"]
    bare = dict(w, shadow_spheres=0.0, shadow_planes=0.0)
    ms0, by0, units0 = k1_lit.k1_lit_bound(spec, 2_097_152, bare)
    want = counts.k1_bound(spec, 2_097_152, bare)
    assert (ms0, by0) == want[:2]
    assert {k: units0[k] for k in ("fp32", "sfu", "int32")} == {
        k: want[2][k] for k in ("fp32", "sfu", "int32")}


LIT_WORK = {"visits": 1.95, "hits": 0.96, "last_hits": 0.01, "misses": 0.0,
            "chunks": 0.0, "shadow": 1.9, "shadow_spheres": 1.9,
            "shadow_planes": 1.9}
LIT_SPEC = types.SimpleNamespace(shape_type=(1, 0), n_indirect=0,
                                 n_lights=2, cam_type=1, max_depth=4,
                                 cam_samples=2)


def test_k1_lit_counts():
    """K1's lane operations, the shadow rays' tests at K1's own counts a
    sphere and a plane, 28 B a lane, 96 an object and 64 a light."""
    ops = k1_lit.k1_lit_ops(LIT_SPEC, LIT_WORK)
    want = (counts.k1_lane_ops(LIT_SPEC, LIT_WORK)
            + 1.9 * np.array(counts.K1_SPHERE)
            + 1.9 * np.array(counts.K1_PLANE))
    np.testing.assert_array_equal(ops, want)
    nbytes = 28 * 1000 + 96 * 2 + lit.LIGHT_BYTES * 2
    assert k1_lit.k1_lit_bound(LIT_SPEC, 1000, LIT_WORK) == \
        counts.unit_bound(ops * 1000, nbytes)


def _k1_run(monkeypatch, span_counts, large=False, spec=LIT_SPEC):
    """A traced run of one request of two K1 launches (1 ms and 3 ms on the
    device), each wrapper span counting ``span_counts[j]``."""
    root = Record("image_loop", 0, None, 0, 9_000, {})
    records, ops = [root], []
    for j, c in enumerate(span_counts):
        records.append(Record("megakernel_linear", len(records), 0, 100 + j,
                              200 + j, c))
        ops.append(Op("void megakernel_linear<true, 0, false>(Params)",
                      1000 * j, 1000 * j + 1000 + 2000 * j))
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    return types.SimpleNamespace(
        trace=Trace(ops, [], [], (0.0, 10_000.0)),
        launches={"megakernel_linear": 2}, large=large, spec=spec,
        window=types.SimpleNamespace(traced=1),
        work=lambda: LIT_WORK, traced_lanes=lambda: 1_920_000)


INSTANCE = {"large": 0, "lights": 2, "lens": 2}


@pytest.mark.parametrize("span_counts, lanes", [
    # this program's spans: each launch's lanes, its instance the scene's
    ([dict(INSTANCE, lanes=3_840_000), dict(INSTANCE, lanes=1_280_000)],
     (3_840_000, 1_280_000)),
    # a program whose K1 spans count the lanes alone
    ([{"lanes": 3_840_000}] * 2, (3_840_000,) * 2),
    # a program whose spans count nothing: the traced lanes, each with its
    # two lens samples, shared evenly
    ([{}, {}], (1_920_000,) * 2),
])
def test_k1_lit_roofline_reads_the_spans(monkeypatch, span_counts, lanes):
    read = manifest.reader("k1_lit_roofline")
    run = _k1_run(monkeypatch, span_counts)
    want = 100.0 * sum(k1_lit.k1_lit_bound(LIT_SPEC, n, LIT_WORK)[0]
                       for n in lanes) / 4.0
    assert read(run) == pytest.approx(want, rel=1e-12)
    assert 0 < read(run) < 100


@pytest.mark.parametrize("fault", ["large", "lights", "lens", "scene_large",
                                   "unlit", "lost"])
def test_k1_lit_roofline_refuses(monkeypatch, fault):
    """None on a launch whose span names another instance (K1-large, no
    lights, one lens sample), on a large scene, on a scene without lights,
    and where the trace lost a launch."""
    span = dict(INSTANCE, lanes=3_840_000)
    if fault in ("large", "lights", "lens"):
        span[fault] = {"large": 1, "lights": 0, "lens": 1}[fault]
    spec = (types.SimpleNamespace(**dict(vars(LIT_SPEC), n_lights=0))
            if fault == "unlit" else LIT_SPEC)
    run = _k1_run(monkeypatch, [dict(INSTANCE, lanes=3_840_000), span],
                  large=fault == "scene_large", spec=spec)
    if fault == "lost":
        run.launches = {"megakernel_linear": 3}
    assert manifest.reader("k1_lit_roofline")(run) is None
