"""sRGB and BMP parity of the PyTorch port: bytes equal the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu import color as jcolor
from raytrace_tpu.io import bmp as jbmp
from raytrace_tpu_torch import color as tcolor
from raytrace_tpu_torch.io import bmp as tbmp


def test_tables_equal():
    np.testing.assert_array_equal(tcolor.SRGB_VALUES, jcolor.SRGB_VALUES)
    np.testing.assert_array_equal(tcolor.SRGB_AVERAGE, jcolor.SRGB_AVERAGE)


def _edge_values():
    avg32 = jcolor.SRGB_AVERAGE.astype(np.float32)
    edges = np.concatenate([
        avg32, np.nextafter(avg32, np.float32(-1)),
        np.nextafter(avg32, np.float32(2)),
        np.array([0.0, -0.0, -1.0, 1.0, 1.5, 1e30, np.inf, -np.inf, np.nan],
                 np.float32)])
    rs = np.random.RandomState(0)
    return np.concatenate([edges, rs.uniform(-0.1, 1.2, 50_000)
                           .astype(np.float32)])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_to_srgb_bytes_equal(dtype):
    v = _edge_values().astype(dtype)
    got = tcolor.to_srgb(torch.from_numpy(v))
    want = np.asarray(jcolor.to_srgb(jnp.asarray(v)))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy()[np.isnan(v)].tolist() == [255]


def test_from_srgb_and_linear_bytes():
    b = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        tcolor.from_srgb(torch.from_numpy(b)).numpy(),
        np.asarray(jcolor.from_srgb(jnp.asarray(b))))
    v = np.random.RandomState(1).uniform(-0.5, 1.5, 10_000).astype(np.float32)
    np.testing.assert_array_equal(
        tcolor.linear_rgb_bytes(torch.from_numpy(v)).numpy(),
        np.asarray(jcolor.linear_rgb_bytes(jnp.asarray(v))))


@pytest.mark.parametrize("w,h", [(8, 8), (5, 3)])
def test_bmp_bytes_equal(tmp_path, w, h):
    img = np.random.RandomState(w).randint(0, 256, (h, w, 3)).astype(np.uint8)
    a, b = tmp_path / "port.bmp", tmp_path / "jax.bmp"
    tbmp.write_bmp(str(a), img)
    jbmp.write_bmp(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    assert tbmp.header(w, h) == jbmp.header(w, h)
    np.testing.assert_array_equal(tbmp.read_bmp(str(a)), img)


def test_significance():
    """Twin of tests/test_color.py::test_significance."""
    c = torch.tensor([[0.25, 0.5, 0.125]])
    assert float(tcolor.significance(c)[0]) == pytest.approx(0.875)
    np.testing.assert_array_equal(
        tcolor.significance(torch.tensor([[1.0, 2.0, 3.0], [0.5, 0.0, 0.25]],
                                         dtype=torch.float64)).numpy(),
        np.asarray(jcolor.significance(jnp.asarray([[1.0, 2.0, 3.0],
                                                    [0.5, 0.0, 0.25]]))))


def test_native_encoder_bit_identical_to_python():
    """Twin of tests/test_native.py::test_encoder_bit_identical_to_python:
    the native encoder's bytes are ``to_srgb``'s (and the JAX package's);
    with no native toolchain, ``available`` is False and the encoder gives
    None."""
    from raytrace_tpu.io import native as jnative
    from raytrace_tpu_torch.io import native

    rng = np.random.RandomState(0)
    vals = np.concatenate([
        rng.rand(4096).astype(np.float32) * 1.2 - 0.1,
        tcolor.SRGB_AVERAGE.astype(np.float32),
        np.array([0.0, 1.0, -1.0, 2.0, np.nan, np.inf, -np.inf],
                 np.float32)])
    got = native.encode_srgb_native(vals.reshape(2, -1))
    assert native.available() == jnative.available()
    if not native.available():
        assert got is None
        return
    assert got.shape == (2, len(vals) // 2) and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got.ravel(), tcolor.to_srgb(torch.from_numpy(vals)).numpy())
    np.testing.assert_array_equal(got.ravel(),
                                  jnative.encode_srgb_native(vals))