"""ctypes bindings to the port's native (C++) sRGB encoder.

``csrc/srgb_encode.cpp`` is the port's own sRGB encoder: a table
lookup over a float32's top 16 bits and one compare a value, the same
bytes as :func:`raytrace_tpu_torch.color.to_srgb`.  The host
compiler builds it at first use, never at import; the library is named
by a hash of the source, the flags and the host's CPU (``-march=native``),
lands in ``raytrace_tpu_torch/build/`` and is reused while they are
unchanged.  Where no C++ compiler is available the encoder here returns
None, and :func:`raytrace_tpu_torch.io.bmp.encode_srgb` encodes through
``color.to_srgb`` instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import warnings

import numpy as np

from raytrace_tpu_torch.ops import _build
from raytrace_tpu_torch.utils.profiling import SRGB_ENCODE, span

SOURCE = "srgb_encode.cpp"
# no fast math: NaN, infinities and subnormals keep their IEEE meaning
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
             "-Wall")

_lock = threading.Lock()
_lib = None
_tried = False


class NativeBuildError(RuntimeError):
    """No host C++ compiler, or it refused the encoder's source."""


def _cpu() -> bytes:
    """What ``-march=native`` reads: the host CPU's model and features."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return platform.processor().encode()
    keep = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def library_path() -> str:
    """Where the encoder builds to, named by a hash of its source, the
    compiler flags and the host CPU."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode() + b"\0" + _cpu())
    with open(os.path.join(_build.CSRC_DIR, SOURCE), "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR,
                        f"libsrgb_encode-{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeBuildError("no C++ compiler (g++ or c++) on PATH")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, "-o", tmp,
           os.path.join(_build.CSRC_DIR, SOURCE)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if r.returncode != 0:
        raise NativeBuildError(f"{' '.join(cmd)}:\n{r.stderr}")
    os.replace(tmp, so)  # atomic: other processes never see a partial file


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = library_path()
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
        except (OSError, NativeBuildError):
            return None
        lib.rt_srgb_table_fault.argtypes = []
        lib.rt_srgb_table_fault.restype = ctypes.c_int64
        fault = lib.rt_srgb_table_fault()
        if fault >= 0:
            warnings.warn(
                f"native sRGB table: bucket {fault:#06x} holds two "
                "thresholds; encoding through color.to_srgb instead",
                RuntimeWarning, stacklevel=3)
            return None
        lib.rt_encode_srgb.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64]
        lib.rt_encode_srgb.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library loads (or builds)."""
    return _load() is not None


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
