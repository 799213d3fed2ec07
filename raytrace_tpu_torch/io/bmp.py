"""BMP image writer — byte-identical to the reference's ``src/bmp.rs``.

Emits the same 14-byte file header + 108-byte BITMAPV4-style DIB header
(24bpp, bottom-up, ``BGRs`` sRGB colorspace tag, 72 DPI) and 4-byte
aligned ``(3w + 3) & ~3`` row stride (bmp.rs:10-61), then the pixel
array.  The header was verified byte-for-byte against the reference's
committed ``out.bmp`` (bytes 0-121).

The reference streams rows y = 0..h-1 as they are rendered
(main.rs:56-58); since BMP positive-height means bottom-up storage, row
y=0 is the *bottom* of the displayed image.  :func:`write_bmp` takes the
image in that same row order.

:func:`encode_srgb` is the one way a rendered image becomes sRGB bytes:
the native encoder where its library loads, ``color.to_srgb`` otherwise,
the same bytes either way.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from raytrace_tpu_torch import color
from raytrace_tpu_torch.io import native


def row_stride(width: int) -> int:
    """4-byte-aligned row size in bytes (bmp.rs:11)."""
    return (3 * width + 3) & ~3


def header(width: int, height: int) -> bytes:
    """The 122-byte BMP prefix (bmp.rs:10-61)."""
    pasize = row_stride(width) * height
    fsize = 14 + 108 + pasize
    return b"".join([
        b"BM",
        struct.pack("<I", fsize),
        b"\x00\x00\x00\x00",            # reserved
        struct.pack("<I", 0x7A),        # pixel array offset
        struct.pack("<I", 0x6C),        # DIB header size (108)
        struct.pack("<i", width),
        struct.pack("<i", height),      # positive => bottom-up rows
        struct.pack("<H", 1),           # planes
        struct.pack("<H", 24),          # bpp
        struct.pack("<I", 0),           # BI_RGB, no compression
        struct.pack("<I", pasize),
        struct.pack("<I", 0x0B13),      # 72 DPI horizontal
        struct.pack("<I", 0x0B13),      # 72 DPI vertical
        struct.pack("<I", 0),           # palette colors
        struct.pack("<I", 0),           # important colors
        b"\x00" * 16,                   # RGBA bitmasks (unused for BI_RGB)
        b"BGRs",                        # sRGB colorspace tag
        b"\x00" * 48,                   # CIEXYZ endpoints + gammas
    ])


def encode_srgb(linear: np.ndarray) -> np.ndarray:
    """sRGB bytes (uint8, the same shape) of a float linear image:
    clipped at zero, cast to float32 and encoded by
    :func:`raytrace_tpu_torch.io.native.encode_srgb_native`, or by
    :func:`raytrace_tpu_torch.color.to_srgb` where the native library does
    not load."""
    clipped = np.clip(linear, 0.0, None).astype(np.float32)
    srgb = native.encode_srgb_native(clipped)
    if srgb is None:
        srgb = color.to_srgb(torch.from_numpy(clipped)).numpy()
    return srgb


def encode_rows(srgb_rgb: np.ndarray) -> np.ndarray:
    """Pack (H, W, 3) uint8 RGB rows into padded BGR row bytes
    (color.rs:628-632 write_bgr + main.rs:56-58 row layout).

    Input row 0 = bottom of the image (the order the reference writes).
    Returns (H, stride) uint8.
    """
    h, w, _ = srgb_rgb.shape
    stride = row_stride(w)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : 3 * w].reshape(h, w, 3)[:] = srgb_rgb[..., ::-1]  # RGB -> BGR
    return rows


def write_bmp(path: str, srgb_rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 sRGB image (row 0 = bottom) as BMP."""
    h, w, _ = srgb_rgb.shape
    with open(path, "wb") as f:
        f.write(header(w, h))
        f.write(encode_rows(srgb_rgb).tobytes())


def read_bmp(path: str) -> np.ndarray:
    """Read a 24bpp bottom-up BMP back to (H, W, 3) uint8 sRGB
    (row 0 = bottom).  Supports exactly the format written above — used
    by tests to compare against the reference's golden ``out.bmp``."""
    with open(path, "rb") as f:
        blob = f.read()
    assert blob[:2] == b"BM"
    offset = struct.unpack("<I", blob[10:14])[0]
    width = struct.unpack("<i", blob[18:22])[0]
    height = struct.unpack("<i", blob[22:26])[0]
    bpp = struct.unpack("<H", blob[28:30])[0]
    assert bpp == 24 and height > 0
    stride = row_stride(width)
    rows = np.frombuffer(blob, np.uint8, count=stride * height, offset=offset)
    rows = rows.reshape(height, stride)[:, : 3 * width]
    return rows.reshape(height, width, 3)[..., ::-1]  # BGR -> RGB
