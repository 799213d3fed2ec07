"""Counter-based RNG: every random number is a pure function of its
identity (seed, pixel, sample, depth, purpose, slot).

PyTorch counterpart of the ``mix`` backend of :mod:`raytrace_tpu.ops.rng`,
bit for bit.  PyTorch has no full set of uint32 operators on every
device (on the CPU ``+``, ``>>`` and ``<`` are missing), so the words
here are **int64 tensors holding values in [0, 2**32)**, masked back to
32 bits after every add and multiply.  One code path serves every
device; the CUDA kernel computes the same bits in ``uint32_t``.
"""

from __future__ import annotations

import torch

# Purpose ids: one independent stream family per use site.
PURPOSE_AA_X = 0       # main.rs:51 jitter
PURPOSE_AA_Y = 1       # main.rs:52 jitter
PURPOSE_LENS_THETA = 2  # camera.rs:115
PURPOSE_LENS_R = 3      # camera.rs:117
PURPOSE_LIGHT_U = 64     # scene.rs:153 (area light, first draw)
PURPOSE_LIGHT_V = 65     # scene.rs:153 (area light, second draw)
PURPOSE_INDIRECT_R1 = 1 << 16  # raytrace.rs:101
PURPOSE_INDIRECT_R2 = (1 << 16) + 1  # raytrace.rs:102

MASK = 0xFFFFFFFF
_GAMMA = 0x9E3779B9  # golden-ratio increment


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32) and a 32-bit constant,
    split in 16-bit halves so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer: a 32-bit bijective mixer."""
    x = _mul32(x ^ (x >> 16), 0x7FEB352D)
    x = _mul32(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def as_words(x: torch.Tensor) -> torch.Tensor:
    """Integer identity tensor -> int64 word in [0, 2**32)."""
    return x.to(torch.int64) & MASK


def hash_words(seed: int, *words: torch.Tensor) -> torch.Tensor:
    """Hash integer identity words into uniform random 32-bit words.
    Each word is absorbed with a distinct golden-ratio offset and mixed,
    sponge-style; the words broadcast against each other."""
    h = (int(seed) & MASK) ^ 0x243F6A88  # pi fractional bits
    for i, w in enumerate(words):
        h = _mix32((h + as_words(w) + ((_GAMMA * (2 * i + 1)) & MASK))
                   & MASK)
    return _mix32(h)


def to_float(u: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Word -> float, for values below 2**31 (cast through int32)."""
    return u.to(torch.int32).to(dtype)


def uniform_from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Map 32-bit words to uniforms in [0, 1)."""
    if dtype == torch.float64:
        hi = to_float(bits >> 6, torch.float64)                   # 26 bits
        lo = _mix32((bits + _GAMMA) & MASK) >> 5                  # 27 bits
        return (hi * (1 << 27) + to_float(lo, torch.float64)) * (2.0 ** -53)
    return to_float(bits >> 8, dtype) * (2.0 ** -24)


def make_keys(seed: int, *words: torch.Tensor):
    """A 64-bit-per-lane stream identity (two words) from integer
    identity words, from two independently salted sponges."""
    s = int(seed) & MASK
    return (hash_words(s ^ 0x243F6A88, *words),
            hash_words(s ^ 0x85A308D3, *words))


def derive(k1: torch.Tensor, k2: torch.Tensor, slot: int):
    """Child-stream derivation: each child slot gets its own stream."""
    s = slot + 1
    return (_mix32((k1 + ((_GAMMA * s) & MASK)) & MASK),
            _mix32(k2 ^ ((0xBB67AE85 * s) & MASK)))


def draw(k1: torch.Tensor, k2: torch.Tensor, purpose: int,
         dtype: torch.dtype) -> torch.Tensor:
    """One uniform [0,1) draw from stream (k1, k2) for a static purpose."""
    bits = _mix32(k1 ^ _mix32((k2 + ((_GAMMA * (purpose + 1)) & MASK))
                              & MASK))
    return uniform_from_bits(bits, dtype)
