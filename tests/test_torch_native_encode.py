"""The port's native sRGB encoder (``csrc/srgb_encode.cpp``): its bytes
equal ``color.to_srgb``'s and the JAX package's native encoder's on every
kind of float32 the table can split (each bucket's ends, the thresholds
and their neighbours, zeros, subnormals, infinities, NaNs of both signs
and a sweep of the bit patterns); the CLI's file, encoded through
``bmp.encode_srgb``, is the Python writer's; where the library cannot be
built, or its table fails the build check, the encoder gives None and
``bmp.encode_srgb`` falls back to ``color.to_srgb`` with the same
bytes."""

import os
import shutil

import numpy as np
import pytest
import torch

from raytrace_tpu_torch import color
from raytrace_tpu_torch.io import bmp, native
from raytrace_tpu_torch.ops import _build

needs_compiler = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("c++") is None,
    reason="no host C++ compiler")


def _bits(b) -> np.ndarray:
    return np.asarray(b, np.uint32).view(np.float32)


def _buckets():
    """The first and the last bit pattern of each of the 65,536 buckets
    that share their top 16 bits."""
    top = np.arange(1 << 16, dtype=np.uint32) << 16
    return _bits(np.concatenate([top, top | 0xFFFF]))


def _thresholds():
    """Each float32 threshold and the 4 floats on either side of it."""
    avg = color.SRGB_AVERAGE.astype(np.float32).view(np.int32)
    return (avg[:, None] + np.arange(-4, 5, dtype=np.int32)).view(
        np.float32).ravel()


def _specials():
    return _bits([
        0x00000000, 0x80000000,                  # +0, -0
        0x00000001, 0x007FFFFF,                  # subnormals, smallest, largest
        0x80000001, 0x807FFFFF,
        0x00800000, 0x7F7FFFFF, 0xFF7FFFFF,      # smallest normal, +-max
        0x3F800000, 0xBF800000,                  # +-1
        0x7F800000, 0xFF800000,                  # +-inf
        0x7F800001, 0x7FC00000, 0x7FFFFFFF,      # NaNs
        0xFF800001, 0xFF80FFFF, 0xFFC00000, 0xFFFFFFFF,
    ])


def _sweep():
    """About 10^6 bit patterns, every 4,297th (an odd stride, so that the
    low bits vary too)."""
    return _bits(np.arange(0, 1 << 32, 4297, dtype=np.uint64)
                 .astype(np.uint32))


@needs_compiler
@pytest.mark.parametrize("values", [_buckets, _thresholds, _specials, _sweep],
                         ids=["buckets", "thresholds", "specials", "sweep"])
def test_bytes_equal_to_python_and_jax(values):
    from raytrace_tpu.io import native as jnative

    v = values()
    got = native.encode_srgb_native(v)
    assert got is not None and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, color.to_srgb(torch.from_numpy(v)).numpy())
    np.testing.assert_array_equal(got, jnative.encode_srgb_native(v))
    assert (got[np.isnan(v)] == 255).all()


@needs_compiler
@pytest.mark.parametrize("w,h", [(13, 7), (1, 1), (801, 3)])
def test_bmp_equals_python_writer(tmp_path, w, h):
    """The CLI's bytes (``bmp.header`` and ``bmp.encode_rows`` of
    ``bmp.encode_srgb``, the native encoder here) are the file the Python
    writer makes of ``color.to_srgb``'s bytes."""
    rng = np.random.RandomState(w)
    img = (rng.rand(h, w, 3) * 1.4 - 0.1).astype(np.float32)
    img.flat[::5] = np.nan
    img.flat[1::7] = np.inf
    assert native.available()
    ours = bmp.header(w, h) + bmp.encode_rows(bmp.encode_srgb(img)).tobytes()
    py = tmp_path / "python.bmp"
    bmp.write_bmp(str(py), color.to_srgb(torch.from_numpy(img)).numpy())
    assert ours == py.read_bytes()


def _forget(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def _fresh_load(monkeypatch, tmp_path):
    """Forget the loaded library and build into an empty directory."""
    _forget(monkeypatch)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))


@needs_compiler
def test_library_is_the_ports_own_and_reused(monkeypatch):
    """The port loads its own build of ``csrc/srgb_encode.cpp`` from the
    kernels' build directory, and a second load finds it built."""
    assert native.available()
    so = native.library_path()
    assert os.path.dirname(so) == _build.BUILD_DIR
    assert os.path.basename(so).startswith("libsrgb_encode-")
    assert native._lib._name == so

    def refuse(_so):
        raise native.NativeBuildError("built again")

    _forget(monkeypatch)
    monkeypatch.setattr(native, "_compile", refuse)
    assert native.available()


@pytest.mark.parametrize("fault", ["no_compiler", "compiler_refuses"])
def test_no_library_falls_back(monkeypatch, tmp_path, fault):
    _fresh_load(monkeypatch, tmp_path)
    if fault == "no_compiler":
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
    else:
        monkeypatch.setattr(native, "CXX_FLAGS",
                            native.CXX_FLAGS + ("-no-such-flag",))
    img = np.random.RandomState(3).uniform(-0.2, 1.3, (2, 3, 3))
    img.flat[::4] = np.nan
    assert not native.available()
    assert native.encode_srgb_native(img) is None
    want = color.to_srgb(torch.from_numpy(
        np.clip(img, 0.0, None).astype(np.float32))).numpy()
    calls, to_srgb = [], color.to_srgb
    monkeypatch.setattr(color, "to_srgb",
                        lambda x: calls.append(x.dtype) or to_srgb(x))
    got = bmp.encode_srgb(img)
    assert calls == [torch.float32]
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@needs_compiler
def test_table_fault_refuses_the_library(monkeypatch, tmp_path):
    """A source whose table puts two thresholds in one bucket is built,
    refused with a warning, and the functions fall back."""
    src = os.path.join(_build.CSRC_DIR, native.SOURCE)
    with open(src) as f:
        text = f.read()
    end = "avg[255] = std::numeric_limits<float>::infinity();"
    assert end in text
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / native.SOURCE).write_text(text.replace(
        end, end + " avg[100] = std::nextafter(avg[101], 0.0f);"))
    _fresh_load(monkeypatch, tmp_path)
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    with pytest.warns(RuntimeWarning, match="holds two thresholds"):
        assert not native.available()
    assert native.encode_srgb_native(np.zeros(3, np.float32)) is None
