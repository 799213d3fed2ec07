"""``field1k_mix.final``'s check, yardstick and roofline reader: on a small
mixed field at a CPU test's size, a sound run is correct and each render
fault is not, and the bfloat16 control reads above the cell's limit; the
tree reference's work counts are the port's ``render/work.py``'s on the
same lanes; ``k3_large_roofline`` reads each launch's lanes from its
wrapper's span, or shares the traced lanes evenly where no span counts
them."""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from benchmark import drive, manifest, program_spans, scenes
from benchmark.reference import tree
from benchmark.tests.test_harness_faults import (_altered, _correct, _encode,
                                                 _encode_fallback,
                                                 _half_batch, _stale)
from benchmark.trace import Op, Spans, Trace
from benchmark.yardstick import counts
from raytrace_tpu_torch.render import work as port_work
from raytrace_tpu_torch.render.integrator import lane_ids
from raytrace_tpu_torch.scene import dsl
from raytrace_tpu_torch.scene.builder import build_scene
from raytrace_tpu_torch.utils.profiling import Record

CPU = torch.device("cpu")
CELL = "field1k_mix.final"


@pytest.fixture
def small_mix(small_cell):
    """``field1k_mix.final`` at 16x16x8 over a mixed field of 100 spheres
    (the large regime, at a CPU test's cost)."""
    b = small_cell(CELL)
    b.scene_text = scenes.sphere_field(100, width=16, height=16,
                                       antialias=8, mix_materials=True)
    b.ref = b.reference.parse(b.scene_text)
    return b


def test_sound_run_is_correct(small_mix):
    ok, checks = _correct(small_mix)
    assert ok, checks


@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered, _encode,
                                   _encode_fallback])
def test_render_fault_is_caught(small_mix, monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _correct(small_mix)
    assert not ok, checks


def test_control_fails(small_mix):
    cell = drive.RenderCell(small_mix, CPU, Spans())
    cell.setup()
    for _ in range(small_mix.traffic["check_images"]):
        cell.request(cell.next_seed())
    cell.free()
    low = cell.check(control=torch.bfloat16)
    assert low["pixel_gap"] > small_mix.limits["pixel_gap"], low


@pytest.mark.parametrize("n", [40, 100])
def test_work_is_the_ports(n):
    """``tree.work`` on 64 lanes equals ``render/work.py::path_work`` of
    the port's plain walk on the same lanes: live nodes, hits, hits at the
    last depth, misses and, at 100 spheres, the sphere chunks entered."""
    text = scenes.sphere_field(n, width=16, height=16, mix_materials=True,
                               seed=5)
    sc = build_scene(dsl.parse(text), device="cpu")
    sc = dataclasses.replace(sc, spec=dataclasses.replace(
        sc.spec, width=16, height=16))
    g = torch.Generator().manual_seed(3)
    pix = torch.randint(0, 256, (64,), generator=g)
    lanes = lane_ids(pix % 16, pix // 16, torch.arange(4), 1)
    want = port_work.path_work(sc.data, sc.spec, lanes, 77)
    ref = tree.parse(text)
    got = tree.work(ref, tree.leaves(ref, "cpu", torch.float32), lanes[:3],
                    77, 16, 16, large=n > 64)
    assert want["visits"] > 1 + want["last_hits"]      # the tree fans out
    assert (want["chunks"] > 0) == (n > 64)
    for k in ("visits", "hits", "last_hits", "misses", "chunks"):
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k


KERNEL = "void megakernel_tree<8, 1, false>(Params)"
WORK = {"visits": 6.25, "hits": 6.0, "last_hits": 1.0, "misses": 0.0,
        "chunks": 21.5}
SPEC = types.SimpleNamespace(shape_type=(1,) * 6 + (0,) * 1000)


def _synthetic(monkeypatch, span_lanes):
    """A traced run of two requests, two launches each (1 ms and 3 ms on
    the device), and the program's record: each launch's wrapper span
    under its request's ``image_loop``, counting ``span_lanes`` (None: no
    count, as a program older than it keeps)."""
    records, ops = [], []
    for k in range(2):
        t = k * 10_000
        root = Record("image_loop", len(records), None, t, t + 9_000, {})
        records.append(root)
        for j in range(2):
            lanes = span_lanes[2 * k + j] if span_lanes else None
            records.append(Record(
                "megakernel_tree", len(records), root.id, t + 100 + j,
                t + 200 + j, {} if lanes is None else {"lanes": lanes}))
            start = t + 1000 * j
            ops.append(Op(KERNEL, start, start + 1000 + 2000 * j))
    monkeypatch.setattr(program_spans, "program_records", lambda: records)
    return types.SimpleNamespace(
        trace=Trace(ops, [], [], (0.0, 20_000.0)),
        launches={"megakernel_tree": 4}, large=True, spec=SPEC,
        window=types.SimpleNamespace(traced=2),
        work=lambda: WORK, traced_lanes=lambda: 4 * 3_000_000)


def _want(lanes) -> float:
    ms = sum(counts.bound(*counts.render_counts(SPEC, n, WORK, large=True)
                          )[0] for n in lanes)
    return 100.0 * ms / 8.0


@pytest.mark.parametrize("span_lanes, lanes", [
    ((1_000_000, 2_000_000, 4_194_304, 4_194_304),
     (1_000_000, 2_000_000, 4_194_304, 4_194_304)),
    (None, (3_000_000,) * 4),
])
def test_k3_large_roofline_reads_the_spans(monkeypatch, span_lanes, lanes):
    """With counts, each launch's own lanes; without, the traced lanes
    (here 12,000,000) shared among the four launches."""
    read = manifest.reader("k3_large_roofline")
    run = _synthetic(monkeypatch, span_lanes)
    assert read(run) == pytest.approx(_want(lanes), rel=1e-12)
    assert 0 < read(run) < 100
    run.launches = {"megakernel_tree": 5}      # a launch the trace lost
    assert read(run) is None
