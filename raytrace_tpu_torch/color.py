"""Linear-RGB helpers and sRGB conversion (color.rs).

PyTorch counterpart of :mod:`raytrace_tpu.color`.  The two lookup tables
of the reference are the IEC 61966-2-1 sRGB transfer function evaluated
in float64: ``SRGB_VALUES[i]`` is the linear value of byte ``i``
(color.rs:75-332) and ``SRGB_AVERAGE`` the midpoints between neighbours
(color.rs:335-591), the encoder's decision thresholds.
"""

from __future__ import annotations

import numpy as np
import torch

from raytrace_tpu_torch.utils.profiling import SRGB_ENCODE, span


def _srgb_decode_f64(byte_over_255: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 sRGB electro-optical transfer function in f64."""
    c = byte_over_255
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


SRGB_VALUES = _srgb_decode_f64(np.arange(256, dtype=np.float64) / 255.0)
SRGB_AVERAGE = 0.5 * (SRGB_VALUES[:-1] + SRGB_VALUES[1:])


def significance(color: torch.Tensor) -> torch.Tensor:
    """``r + g + b`` over the trailing color axis (color.rs:637-639), the
    measure that gates shading work against the minimum significance."""
    return torch.sum(color, dim=-1)


def to_srgb(val: torch.Tensor) -> torch.Tensor:
    """Encode linear values to sRGB bytes exactly like color.rs:593-600:
    the smallest ``i`` with ``val < SRGB_AVERAGE[i]``, else 255.  That is
    ``searchsorted(..., right=True)`` against the thresholds in
    ``val``'s dtype; NaN sorts past the end and encodes as 255.  Runs
    under the profiler span ``srgb_encode``, as the native encoder does."""
    with span(SRGB_ENCODE):
        thresholds = torch.as_tensor(SRGB_AVERAGE).to(device=val.device,
                                                     dtype=val.dtype)
        return torch.searchsorted(thresholds, val.contiguous(),
                                  right=True).to(torch.uint8)


def from_srgb(byte: torch.Tensor, *, dtype=torch.float32) -> torch.Tensor:
    """Decode sRGB bytes to linear values via the table (color.rs:611-613)."""
    table = torch.as_tensor(SRGB_VALUES).to(device=byte.device, dtype=dtype)
    return table[byte.to(torch.int64)]


def linear_rgb_bytes(val: torch.Tensor) -> torch.Tensor:
    """``trunc(val * 255)`` clamped to [0, 255] (color.rs:617-625)."""
    return torch.clamp(torch.trunc(val * 255.0), 0.0, 255.0).to(torch.uint8)
