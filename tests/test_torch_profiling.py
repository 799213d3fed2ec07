"""The profiler ranges of the render phases, the image loop and the
encoders (``utils/profiling.py``) and the CLI's ``--profile``, on the CPU:
the ranges leave results unchanged, a recording names raygen, intersect,
shade, background, grad_psum and the kernel wrapper's range, the program
keeps a record of its spans while a profiler records and none otherwise,
and ``--profile DIR`` writes a Chrome trace that names them."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from raytrace_tpu_torch import color, optim
from raytrace_tpu_torch.io import native
from raytrace_tpu_torch.ops.kernel_grad import kernel_forward
from raytrace_tpu_torch.parallel import multihost
from raytrace_tpu_torch.parallel.mesh import Mesh
from raytrace_tpu_torch.render import integrator, megakernel
from raytrace_tpu_torch.scene.builder import load_scene_file
from raytrace_tpu_torch.utils import profiling

from conftest import repo_path
from test_torch_cli import _run

CORNELL = str(repo_path("examples", "cornell_indirect.txt"))
SHOWCASE = str(repo_path("examples", "materials_showcase.txt"))
PHASES = {"raygen", "intersect", "shade", "background"}
# the image loop's spans, each under its parent's name
LOOP = {"issue": "image_loop", "wait": "image_loop", "fetch": "image_loop",
        "accumulate": "image_loop", "progress": "image_loop",
        "checkpoint": "image_loop"}
# the spans of three groups issued one ahead of the host's wait, each
# wait counting the groups queued behind it, and the one fetch a render
AHEAD = (["issue", "issue", "wait", "accumulate", "progress", "issue", "wait",
          "accumulate", "progress", "wait", "accumulate", "progress",
          "fetch"], [1, 1, 0])


def _ranges(prof) -> set:
    return {e.key for e in prof.key_averages()}


def test_annotate_names_the_phases_and_changes_nothing():
    sc = load_scene_file(SHOWCASE, device="cpu")
    rs = np.random.RandomState(2)
    lanes = [torch.from_numpy(a.astype(np.int64)) for a in (
        rs.randint(0, 640, 64), rs.randint(0, 400, 64),
        rs.randint(0, 4, 64), rs.randint(0, 4, 64))]
    plain = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        recorded = megakernel.radiance_lanes(sc.data, sc.spec, *lanes, 2)
    assert PHASES <= _ranges(prof)
    for a, b in zip(plain, recorded):
        assert torch.equal(a, b)
    # the wrapper returns the function's own result and keeps its name
    assert profiling.annotate("x")(lambda a, b=1: (a, b))(3, b=4) == (3, 4)
    assert megakernel.radiance_lanes_reference.__name__ \
        == "radiance_lanes_reference"
    from raytrace_tpu_torch.render.integrator import primary_rays
    assert primary_rays.__name__ == "primary_rays"


def test_kernel_range_and_grad_psum():
    """``kernel_forward`` records its kernel's name, forward and backward
    alike, and the sharded step's all-reduce records ``grad_psum`` (one
    rank on the CPU: the range with nothing in it)."""
    x = torch.linspace(0.0, 1.0, 8, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, = kernel_forward(lambda t: (t * 2.0,), lambda t: (t * 2.0,), x,
                            name="megakernel_linear")
        y.sum().backward()
    assert "megakernel_linear" in _ranges(prof)
    assert torch.equal(x.grad, torch.full((8,), 2.0))
    sc = load_scene_file(CORNELL, device="cpu")
    spec = dataclasses.replace(sc.spec, width=4, height=4)
    pix = torch.arange(16)
    step = optim.make_sharded_step(spec, Mesh(torch.device("cpu")), 1)
    loss0, _ = optim.loss_and_grad(sc.data, spec, pix % 4, pix // 4,
                                   torch.arange(2), 1,
                                   torch.full((16, 3), 0.25))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        loss, _ = step(sc.data, pix % 4, pix // 4, torch.arange(2),
                       torch.full((16, 3), 0.25))
    assert (PHASES | {"grad_psum"}) <= _ranges(prof)
    assert float(loss) == float(loss0)


def test_cli_profile_writes_a_trace(tmp_path):
    """``--profile DIR`` on ``--device cpu``: the same BMP as without it,
    and a Chrome trace in DIR whose ranges name the render phases, the
    image loop's steps and the encode."""
    common = [CORNELL, "--width", "8", "--height", "8", "--spp", "2", "-q",
              "--device", "cpu"]
    r = _run([*common, "-o", str(tmp_path / "p.bmp"), "--profile",
              str(tmp_path / "trace")])
    assert r.returncode == 0, r.stderr
    plain = _run([*common, "-o", str(tmp_path / "x.bmp")])
    assert plain.returncode == 0, plain.stderr
    assert (tmp_path / "p.bmp").read_bytes() == (
        tmp_path / "x.bmp").read_bytes()
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert PHASES <= names
    assert {"image_loop", "issue", "fetch", "accumulate", "progress",
            "srgb_encode"} <= names


def test_span_without_a_profiler_records_nothing(monkeypatch):
    """With no profiler recording, a span is one shared context that does
    nothing: no record and no ``record_function``."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened")

    monkeypatch.setattr(profiling, "record_function", refuse)
    before = len(profiling.recorded())
    nothing = profiling.span("fetch", bytes=12)
    assert nothing is profiling.span("image_loop")
    with nothing:
        with profiling.span("issue"):
            pass
    assert profiling.annotate("x")(lambda: 7)() == 7
    assert len(profiling.recorded()) == before


def _cornell16():
    sc = load_scene_file(CORNELL, device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=16, height=16))


def _render(sc, checkpoint=None):
    """Two groups of two 2-sample chunks and a ragged 1-sample tail (with
    ``CHUNK_GROUP`` 2), with a progress call a group, and a checkpoint a
    group where a path is given."""
    return integrator._image_loop(sc, seed=5, spp=9, max_lanes=512,
                                  progress=lambda f: None,
                                  checkpoint=checkpoint)


@pytest.mark.parametrize("checkpointed", [True, False])
def test_image_loop_records_its_spans(tmp_path, monkeypatch, checkpointed):
    """Under torch.profiler, two renders record the image loop's spans,
    each under its parent, all of a render under one ``image_loop`` of its
    own.  Where a checkpoint is written, a group's ``issue``,
    ``accumulate``, ``progress``, a ``fetch`` of the float64 sum and the
    ``checkpoint``, one group after another; without one, the next
    group's ``issue`` before each group's ``wait`` (``ahead`` 1, the last
    0), ``accumulate`` and ``progress``.  Then one last ``fetch`` a
    render.  Every fetch counts the float64 image's bytes; each
    ``sample_pixels`` call's phases lie inside its group's ``issue``; the
    image is the same to the bit."""
    sc = _cornell16()
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 2)

    def path(name):
        return str(tmp_path / name) if checkpointed else None

    plain = _render(sc, path("a.npz"))
    calls = []
    inner = integrator.sample_pixels

    def counted(data, spec, px, py, sample_ids, seed, radiance=None):
        calls.append([r.name for r in profiling.recorded()
                      if r.end_ns is None])
        return inner(data, spec, px, py, sample_ids, seed, radiance)

    monkeypatch.setattr(integrator, "sample_pixels", counted)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        images = [_render(sc, path(f"{i}.npz")) for i in (0, 1)]
    for img in images:
        assert np.array_equal(img, plain)
    recs = profiling.recorded()
    by_id = {r.id: r for r in recs}

    def outermost(r):
        while r.parent is not None:
            r = by_id[r.parent]
        return r

    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["image_loop", "image_loop"]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent is not None:
            up = by_id[r.parent]
            assert up.start_ns <= r.start_ns and r.end_ns <= up.end_ns
            if r.name in LOOP:
                assert up.name == LOOP[r.name], r
            if r.name in PHASES:
                assert up.name == "issue", r
    group = ["issue", "accumulate", "progress", "fetch", "checkpoint"]
    for root in roots:
        mine = [r for r in recs if outermost(r) is root]
        if checkpointed:
            assert [r.name for r in mine if r.name in LOOP] == group * 3 + [
                "fetch"]
            assert not [r for r in mine if r.name == "wait"]
        else:
            assert [r.name for r in mine if r.name in LOOP] == AHEAD[0]
            assert [r.counts for r in mine if r.name == "wait"] == [
                {"ahead": a} for a in AHEAD[1]]
        assert [r.counts for r in mine if r.name == "fetch"] == [
            {"bytes": 16 * 16 * 3 * 8}] * (4 if checkpointed else 1)
    # two renders of two groups of two chunks and a one-chunk tail: each
    # chunk's sample_pixels call made inside its group's issue
    assert calls == [["image_loop", "issue"]] * 10


def test_band_records_the_loop_spans(monkeypatch):
    """``render_rows_multihost`` on one CPU rank goes through the image
    loop: one ``image_loop`` holding each group's ``issue``, the next
    group's issued before its ``wait``, its ``accumulate`` and
    ``progress``, and the one ``fetch`` of the band's float64 bytes, and
    its band is the whole image to the bit."""
    sc = _cornell16()
    monkeypatch.setattr(integrator, "CHUNK_GROUP", 2)
    plain = _render(sc)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        row_lo, row_hi, band = multihost.render_rows_multihost(
            sc, seed=5, spp=9, mesh=Mesh(torch.device("cpu")),
            max_lanes=512, progress=lambda f: None)
    assert (row_lo, row_hi) == (0, 16)
    assert np.array_equal(band, plain)
    recs = profiling.recorded()
    by_id = {r.id: r for r in recs}
    assert [r.name for r in recs if r.parent is None] == ["image_loop"]
    loop = [r for r in recs if r.name in LOOP]
    assert [r.name for r in loop] == AHEAD[0]
    assert [r.counts for r in loop if r.name == "wait"] == [
        {"ahead": a} for a in AHEAD[1]]
    assert all(by_id[r.parent].name == "image_loop" for r in loop)
    assert loop[-1].counts == {"bytes": 16 * 16 * 3 * 8}


def test_encoders_record_srgb_encode():
    """Both encoders, the native one (the port's own library, built from
    ``csrc/srgb_encode.cpp``) and ``color.to_srgb``, record one
    ``srgb_encode`` span, each inside its own call, and encode alike."""
    assert native.available()
    assert native._lib._name == native.library_path()
    vals = np.random.RandomState(4).uniform(0.0, 1.2, (5, 7, 3)).astype(
        np.float32)
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        fast = native.encode_srgb_native(vals)
        t1 = time.time_ns()
        torch_out = color.to_srgb(torch.from_numpy(vals)).numpy()
    assert np.array_equal(fast, torch_out)
    recs = profiling.recorded()
    assert [(r.name, r.counts, r.parent) for r in recs] == [
        ("srgb_encode", {}, None)] * 2
    assert t0 <= recs[0].start_ns <= recs[0].end_ns <= t1 <= recs[1].start_ns
    assert "srgb_encode" in _ranges(prof)
