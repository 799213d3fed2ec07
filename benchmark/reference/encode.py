"""The image file the reference expects for an image: sRGB bytes and a
24-bit BMP (j-dong/rust-raytrace color.rs:593-600, bmp.rs:10-61).

A linear value encodes to the smallest byte whose threshold (the
midpoint of two neighbouring bytes' linear values under IEC 61966-2-1,
rounded to float32) lies above it, else 255; the BMP is a 14-byte file
header, a 108-byte BITMAPV4 header (24 bits, bottom-up rows, the
``BGRs`` colour space, 72 DPI) and BGR rows padded to 4 bytes.
"""

from __future__ import annotations

import struct

import numpy as np


def _thresholds() -> np.ndarray:
    c = np.arange(256, dtype=np.float64) / 255.0
    linear = np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    return (0.5 * (linear[:-1] + linear[1:])).astype(np.float32)


def srgb_bytes(linear: np.ndarray) -> np.ndarray:
    """uint8 sRGB of float32 linear values; NaN encodes as 255."""
    return np.searchsorted(_thresholds(), linear, side="right").astype(
        np.uint8)


def bmp_bytes(image: np.ndarray) -> bytes:
    """The BMP file of an (H, W, 3) linear image, row 0 at the bottom,
    clipped below at 0 and taken in float32, as the CLI writes it."""
    h, w, _ = image.shape
    srgb = srgb_bytes(np.clip(image, 0.0, None).astype(np.float32))
    stride = (3 * w + 3) & ~3
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = srgb[..., ::-1].reshape(h, 3 * w)
    size = stride * h
    head = (b"BM" + struct.pack("<IIII", 122 + size, 0, 122, 108)
            + struct.pack("<iiHHII", w, h, 1, 24, 0, size)
            + struct.pack("<IIII", 0xB13, 0xB13, 0, 0)
            + bytes(16) + b"BGRs" + bytes(48))
    return head + rows.tobytes()
