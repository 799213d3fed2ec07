"""The yardstick's frozen copies, pinned to the originals they were copied
from at commit 6033020: ray_counts, the operation counts and bounds of
flops.py, path_work's counts, device_busy_ms's arithmetic, the sphere
field's text."""

from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from benchmark import scenes
from benchmark.reference import render as ref_render
from benchmark.reference import scene as ref_scene
from benchmark.yardstick import busy, counts, work
from raytrace_tpu_torch import bench as port_bench
from raytrace_tpu_torch.render import work as port_work
from raytrace_tpu_torch.render.integrator import lane_ids
from raytrace_tpu_torch.scene import dsl, procedural
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.utils import flops, profiling

GOLDEN = open(scenes.__file__.replace("scenes.py",
                                      "configs/golden.txt")).read()
FIELD = scenes.sphere_field(100, width=16, height=16, mix_materials=False)


@pytest.mark.parametrize("n, mix", [(100, False), (1000, False), (60, True)])
def test_sphere_field_text(n, mix):
    assert scenes.sphere_field(n, mix_materials=mix) == \
        procedural.sphere_field_source(n, mix_materials=mix)


def _port(text, w=16, h=16):
    sc = build_scene(dsl.parse(text), device="cpu")
    return dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=w, height=h))


@pytest.mark.parametrize("text", [GOLDEN, FIELD])
def test_ray_counts(text):
    spec = _port(text).spec
    assert counts.ray_counts(spec, 640000, 6) == port_bench.ray_counts(
        spec, 640000, 6)
    assert counts.ray_counts(work.ref_spec(ref_scene.parse(text)), 640000,
                             6) == port_bench.ray_counts(spec, 640000, 6)


WORK = {"visits": 4.25, "hits": 3.5, "last_hits": 0.75, "misses": 0.0,
        "chunks": 11.7}


@pytest.mark.parametrize("text", [GOLDEN, FIELD])
def test_flops_copies(text):
    spec = _port(text).spec
    mine = work.ref_spec(ref_scene.parse(text))
    np.testing.assert_array_equal(counts.k1_lane_ops(mine, WORK),
                                  flops.k1_lane_ops(spec, WORK))
    assert counts.k1_bound(mine, 3840000, WORK) == flops.k1_bound(
        spec, 3840000, WORK)
    assert counts.bound(1e12, 3e9) == flops.bound(1e12, 3e9)
    for v in ("fp32_flops", "mem_bytes", "sfu_ops", "int_ops"):
        assert getattr(counts.H100_SXM, v) == getattr(flops.H100_SXM, v)
    assert counts.render_counts(mine, 4194304, WORK) == \
        flops.render_counts(spec, 4194304, WORK)
    if spec.n_objects > 64:
        from raytrace_tpu_torch.ops.intersect import scene_tables
        tables = scene_tables(_port(text).data, spec)
        assert counts.render_counts(mine, 4194304, WORK, large=True) == \
            flops.render_counts(spec, 4194304, WORK, tables)


@pytest.mark.parametrize("text", [GOLDEN, FIELD])
def test_path_work(text):
    """The work counted on the reference's paths equals path_work's on the
    port's plain path for the same lanes."""
    sc = _port(text)
    ref = ref_scene.parse(text)
    g = torch.Generator().manual_seed(3)
    pix = torch.randint(0, 256, (64,), generator=g)
    lanes = lane_ids(pix % 16, pix // 16, torch.arange(4), 1)
    want = port_work.path_work(sc.data, sc.spec, lanes, 77)
    lv = ref_render.leaves(ref, "cpu", torch.float32)
    got = work.path_work(ref, lv, lanes[:3], 77, 16, 16,
                         large=sc.spec.n_objects > 64)
    for k in ("visits", "hits", "last_hits", "misses", "chunks"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


class _Event(types.SimpleNamespace):
    pass


def test_device_busy_arithmetic(monkeypatch):
    """The original's sum, on a recording of made-up events: 64 trivial
    records first, a range and a host event among them."""
    from torch.autograd import DeviceType

    def ev(name, start, dur, device=DeviceType.CUDA, annotation=False):
        return _Event(key=name, name=name, device_type=device,
                      is_user_annotation=annotation, device_time_total=dur,
                      time_range=types.SimpleNamespace(start=start,
                                                       end=start + dur))

    events = [ev("add", i, 1.0) for i in range(64)]
    events += [ev("megakernel_linear", 100, 500.0), ev("k", 100, 300.0),
               ev("Memcpy DtoH", 450, 50.0), ev("bench::x", 90, 900, None,
                                                 True),
               ev("host", 95, 5.0, DeviceType.CPU)]

    class FakeProfile:
        def __init__(self, **kw):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def events(self):
            return events

    zeros = torch.zeros
    monkeypatch.setattr(torch, "zeros", lambda *a, **k: zeros(*a))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    want = profiling.device_busy_ms(lambda: None)
    got = busy.records_ms(busy.device_records(events), skip=64)
    assert got == want == 0.35
    assert busy.union_s([(100, 400), (450, 500), (50, 60)], 0, 1e9) == \
        pytest.approx(360e-6)
