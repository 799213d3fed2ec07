"""Component-separated 3-vectors over tensors.

PyTorch counterpart of :mod:`raytrace_tpu.ops.vec`: the hot path carries
vectors as a ``V3`` of three same-shaped tensors, so every operation is
elementwise over whatever lane shape the caller uses; ``(..., 3)``
appears only at API boundaries (:func:`splat` / :func:`pack`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, o):
        return V3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o):
        return V3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def scale(self, s):
        return V3(self.x * s, self.y * s, self.z * s)

    def mul(self, o: "V3") -> "V3":
        return V3(self.x * o.x, self.y * o.y, self.z * o.z)


def dot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def norm2(a: V3):
    return dot(a, a)


def normalize(a: V3) -> V3:
    return a.scale(torch.rsqrt(norm2(a)))


def safe_normalize(a: V3) -> V3:
    """normalize with a zero-vector guard (returns 0)."""
    n2 = norm2(a)
    pos = n2 > 0
    inv = torch.where(pos, torch.rsqrt(torch.where(pos, n2, 1.0)), 0.0)
    return a.scale(inv)


def where(c, a: V3, b: V3) -> V3:
    return V3(torch.where(c, a.x, b.x), torch.where(c, a.y, b.y),
              torch.where(c, a.z, b.z))


def splat(arr: torch.Tensor) -> V3:
    """(..., 3) -> V3 of (...,) components (API boundary, in)."""
    return V3(arr[..., 0], arr[..., 1], arr[..., 2])


def pack(v: V3) -> torch.Tensor:
    """V3 -> (..., 3) (API boundary, out)."""
    return torch.stack([v.x, v.y, v.z], dim=-1)


def full_like(like: torch.Tensor, v: float) -> V3:
    a = torch.full_like(like, v)
    return V3(a, a, a)
