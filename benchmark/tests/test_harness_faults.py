"""The check catches what it is there to catch: a run whose timed path is
broken underneath comes out not correct, once for each fault its cell
can have, and the control (the reference one precision down, bfloat16,
in the program's place) reads above every cell's limit.  At a CPU
test's size, the look for a card skipped; the cells' own limits."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from benchmark import drive, run
from benchmark.trace import Spans
from raytrace_tpu_torch import color, optim
from raytrace_tpu_torch.io import native
from raytrace_tpu_torch.render import integrator, megakernel

CPU = torch.device("cpu")
RENDER = ["golden.final", "field1k.final", "golden.preview"]


def _correct(bench) -> tuple:
    out = run.run_cell(bench, CPU, 0.05, False)
    return out["correct"], out["checks"]


@pytest.mark.parametrize("workload", RENDER + ["golden.fit"])
def test_sound_run_is_correct(small_cell, workload):
    ok, checks = _correct(small_cell(workload))
    assert ok, checks


def _stale(monkeypatch):
    """Every request answers with the first request's image."""
    real, first = integrator.render_image, []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0].copy()
    monkeypatch.setattr(integrator, "render_image", stale)


def _half_batch(monkeypatch):
    """Half of each launch's samples left out, the mean over the rest."""
    real = integrator.sample_pixels

    def half(data, spec, px, py, sample_ids, seed, radiance=None):
        keep = sample_ids[:max(sample_ids.shape[0] // 2, 1)]
        return real(data, spec, px, py, keep, seed, radiance)
    monkeypatch.setattr(integrator, "sample_pixels", half)


def _altered(monkeypatch):
    """One lane in 16 answers twice its radiance where it is produced."""
    real = megakernel.radiance_lanes

    def altered(*a, **k):
        out = real(*a, **k)
        every = torch.arange(0, out[0].shape[0], 16)
        return type(out)(*(c.index_put((every,), c[every] * 2) for c in out))
    monkeypatch.setattr(megakernel, "radiance_lanes", altered)


def _encode(monkeypatch):
    """The native sRGB encode one byte off on some values."""
    real = native.encode_srgb_native

    def off(val):
        out = real(val)
        if out is None:
            pytest.skip("the native encoder's library does not load here")
        return np.where(out < 255, out + (val > 0.5), out).astype(np.uint8)
    monkeypatch.setattr(native, "encode_srgb_native", off)


def _encode_fallback(monkeypatch):
    """No native library, and the fallback's sRGB encode one byte off on
    some values."""
    real = color.to_srgb

    def off(val):
        out = real(val)
        return torch.where(out < 255, out + (val > 0.5).to(out.dtype), out)
    monkeypatch.setattr(native, "encode_srgb_native", lambda val: None)
    monkeypatch.setattr(color, "to_srgb", off)


@pytest.mark.parametrize("workload", RENDER)
@pytest.mark.parametrize("fault", [_stale, _half_batch, _altered, _encode,
                                   _encode_fallback])
def test_render_fault_is_caught(small_cell, monkeypatch, workload, fault):
    fault(monkeypatch)
    ok, checks = _correct(small_cell(workload))
    assert not ok, checks


def _fit_unchanged(monkeypatch):
    """Adam's step returns the state unchanged."""
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, *a: None)


def _fit_half_batch(monkeypatch):
    """Half of the pixels left out of the loss, the sum over the rest
    doubled (the mean kept)."""
    real = optim.loss_and_grad

    def half(data, spec, px, py, sample_ids, seed, target, trainable=None):
        n = px.shape[0] // 2
        loss, grads = real(data, spec, px[:n], py[:n], sample_ids, seed,
                           target[:n], trainable)
        return loss * 2, type(grads)(**{
            f.name: getattr(grads, f.name) * 2
            for f in dataclasses.fields(grads)})
    monkeypatch.setattr(optim, "loss_and_grad", half)


def _fit_altered(monkeypatch):
    """The camera's gradient answers twice its value."""
    real = optim.loss_and_grad

    def altered(*a, **k):
        loss, grads = real(*a, **k)
        return loss, dataclasses.replace(grads,
                                         cam_matrix=grads.cam_matrix * 2)
    monkeypatch.setattr(optim, "loss_and_grad", altered)


@pytest.mark.parametrize("fault", [_fit_unchanged, _fit_half_batch,
                                   _fit_altered])
def test_fit_fault_is_caught(small_cell, monkeypatch, fault):
    fault(monkeypatch)
    ok, checks = _correct(small_cell("golden.fit"))
    assert not ok, checks


@pytest.mark.parametrize("workload", RENDER + ["golden.fit"])
def test_control_fails(small_cell, workload):
    """The control reads above the cell's limit on some number."""
    bench = small_cell(workload)
    cell = drive.KINDS[bench.traffic["kind"]](bench, CPU, Spans())
    cell.setup()
    for _ in range(bench.traffic.get("check_images", 0)):
        cell.request(cell.next_seed())
    cell.free()
    low = cell.check(control=torch.bfloat16)
    assert any(not v <= bench.limits[k] for k, v in low.items()), low
