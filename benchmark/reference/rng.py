"""The random streams every sample is drawn from, as the reference reads
them: a splitmix32-style finalizer absorbed sponge-wise over a lane's
identity words, two salted sponges to a stream, one draw per purpose.
The words are int64 tensors holding 32-bit values; every product is
taken in 16-bit halves so that none overflows.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
GAMMA = 0x9E3779B9
AA_X, AA_Y = 0, 1                       # the pixel jitter
INDIRECT_R1, INDIRECT_R2 = 1 << 16, (1 << 16) + 1   # an indirect child


def _mul(x, c: int):
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & MASK


def mix(x):
    x = _mul(x ^ (x >> 16), 0x7FEB352D)
    x = _mul(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _sponge(salt: int, words):
    h = salt ^ 0x243F6A88
    for i, w in enumerate(words):
        h = mix((h + (w.to(torch.int64) & MASK)
                 + ((GAMMA * (2 * i + 1)) & MASK)) & MASK)
    return mix(h)


def keys(seed: int, *words):
    """A lane's stream: two words from its identity words."""
    s = int(seed) & MASK
    return _sponge(s ^ 0x243F6A88, words), _sponge(s ^ 0x85A308D3, words)


def child(k1, k2, slot: int):
    """The stream of child slot ``slot``."""
    s = slot + 1
    return (mix((k1 + ((GAMMA * s) & MASK)) & MASK),
            mix(k2 ^ ((0xBB67AE85 * s) & MASK)))


def as_float(words, dtype):
    return words.to(torch.int32).to(dtype)


def uniform(k1, k2, purpose: int, dtype):
    """One draw in [0, 1) from a stream: 24 bits, as float32 draws them
    (a float64 render draws 53, which the reference does not)."""
    if dtype == torch.float64:
        raise ValueError("the reference draws 24-bit uniforms only")
    bits = mix(k1 ^ mix((k2 + ((GAMMA * (purpose + 1)) & MASK)) & MASK))
    return as_float(bits >> 8, dtype) * (2.0 ** -24)
