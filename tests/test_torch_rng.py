"""RNG parity of the PyTorch port: every word and every uniform equals the
JAX package's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.ops import rng as jrng
from raytrace_tpu_torch.ops import rng as trng

N = 100_000
# every purpose the ported slice draws: AA jitter and the indirect slot
PURPOSES = [trng.PURPOSE_AA_X, trng.PURPOSE_AA_Y, trng.PURPOSE_INDIRECT_R1,
            trng.PURPOSE_INDIRECT_R2]


def _words(seed, n_words=4):
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
            for _ in range(n_words)]


def _j(a):
    return jnp.asarray(a, jnp.uint32)


def _t(a):
    return torch.from_numpy(a.astype(np.int64))


def _eq(got: torch.Tensor, want):
    want = np.asarray(want)
    if want.dtype == np.uint32:
        assert got.dtype == torch.int64
        assert int(got.min()) >= 0 and int(got.max()) < 2 ** 32
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    else:
        np.testing.assert_array_equal(got.numpy(), want)


def test_mix32_and_mul_wraparound():
    (w,) = _words(0, 1)
    w[:4] = [0, 1, 2 ** 32 - 1, 2 ** 31]
    _eq(trng._mix32(_t(w)), jrng._mix32(_j(w)))


@pytest.mark.parametrize("seed", [0, 3, 2 ** 32 - 1])
def test_hash_words_and_make_keys(seed):
    ws = _words(seed % 1000)
    for k in (1, 3, 4):
        _eq(trng.hash_words(seed, *map(_t, ws[:k])),
            jrng.hash_words(seed, *map(_j, ws[:k])))
    for k in (3, 4):
        got = trng.make_keys(seed, *map(_t, ws[:k]))
        want = jrng.make_keys(seed, *map(_j, ws[:k]))
        _eq(got[0], want[0])
        _eq(got[1], want[1])


@pytest.mark.parametrize("slot", [0, 1, 2, 3])
def test_derive(slot):
    k1, k2 = _words(10 + slot, 2)
    got = trng.derive(_t(k1), _t(k2), slot)
    want = jrng.derive(_j(k1), _j(k2), slot)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("purpose", PURPOSES)
def test_draw_bits_and_uniforms(purpose):
    k1, k2 = _words(20 + purpose % 7, 2)
    got = trng.draw(_t(k1), _t(k2), purpose, torch.float32)
    want = jrng.draw(_j(k1), _j(k2), purpose, jnp.float32)
    assert got.dtype == torch.float32
    _eq(got, want)
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0


@pytest.mark.parametrize("tdtype,jdtype", [(torch.float32, jnp.float32),
                                           (torch.float64, jnp.float64)])
def test_uniform_from_bits(tdtype, jdtype):
    (bits,) = _words(30, 1)
    bits[:3] = [0, 2 ** 32 - 1, 255]
    _eq(trng.uniform_from_bits(_t(bits), tdtype),
        jrng.uniform_from_bits(_j(bits), jdtype))


def test_to_float_pixel_ids():
    ids = np.arange(0, 2 ** 31, 2 ** 31 // 1000, dtype=np.uint32)
    _eq(trng.to_float(_t(ids), torch.float32),
        jrng.to_float(_j(ids), jnp.float32))
