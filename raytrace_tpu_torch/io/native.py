"""ctypes bindings to the native (C++) image-output runtime.

Loads the repository's ``native/build/libraytrace_native.so`` (the C++
sRGB encoder and BMP writer of ``native/bmp_writer.cpp``, shared with the
JAX package), building it with ``make -C native`` on first use.  Returns
False where no C++ toolchain is available, and the caller writes through
the pure-Python encoder instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from raytrace_tpu_torch.utils.profiling import SRGB_ENCODE, span

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO, "native")
_SO = os.path.join(_NATIVE_DIR, "build", "libraytrace_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if not os.path.exists(_SO):
            if not os.path.exists(os.path.join(_NATIVE_DIR, "bmp_writer.cpp")):
                return None
            try:
                subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                               capture_output=True, timeout=120)
            except (OSError, subprocess.SubprocessError):
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.rt_write_bmp.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        lib.rt_write_bmp.restype = ctypes.c_int
        lib.rt_encode_srgb.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.rt_encode_srgb.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library loads (or builds)."""
    return _load() is not None


def write_bmp_native(path: str, linear_rgb: np.ndarray) -> bool:
    """Write an (H, W, 3) float linear image (row 0 = bottom) as BMP via
    the native writer.  Returns False if the native library is
    unavailable (the caller falls back); raises on IO errors."""
    lib = _load()
    if lib is None:
        return False
    img = np.ascontiguousarray(linear_rgb, np.float32)
    h, w, _ = img.shape
    rc = lib.rt_write_bmp(
        path.encode(), img.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        w, h)
    if rc != 0:
        raise OSError(f"native BMP write failed with code {rc}: {path}")
    return True


def encode_srgb_native(linear: np.ndarray) -> np.ndarray | None:
    """sRGB-encode a float array with the native encoder, as uint8 of the
    same shape (None if the library is unavailable), under the profiler
    span ``srgb_encode``, as :func:`raytrace_tpu_torch.color.to_srgb`."""
    lib = _load()
    if lib is None:
        return None
    with span(SRGB_ENCODE):
        flat = np.ascontiguousarray(linear, np.float32).ravel()
        out = np.empty(flat.shape, np.uint8)
        lib.rt_encode_srgb(
            flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), flat.size)
        return out.reshape(np.shape(linear))
