"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` (with the headers beside it) is compiled by
``nvcc`` for Hopper (``sm_90a``) into a shared library with a plain C
interface, loaded with ctypes.  The build runs at first use, never at
import; its output is named by a hash of the sources and flags, lands in
``raytrace_tpu_torch/build/`` and is reused while the sources are
unchanged.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

# no fast math: the kernels keep IEEE sqrt, division, sinf and cosf.
# --split-compile=0 (nvcc 12.1 or later) optimises and assembles a file's
# kernel instances on all the host's cores; the tree kernel's 24 instances
# then build in half the time, with the same registers and stack frames
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# the kernels: one ``csrc/<name>.cu`` each
KERNEL_LINEAR = "megakernel_linear"
KERNEL_TREE = "megakernel_tree"
KERNEL_SCAN = "scan_hit"
KERNEL_SKY = "skybox"
KERNEL_RING = "ring_shade"
KERNELS = (KERNEL_LINEAR, KERNEL_TREE, KERNEL_SCAN, KERNEL_SKY, KERNEL_RING)

# flags of one kernel on top of NVCC_FLAGS.  The tree kernel and the ring's
# kernels are compiled without contraction of multiply-adds, so every
# product and sum rounds as the plain PyTorch path's does and their lanes
# agree with that path to the bit: a lane of a wide tree visits hundreds of
# nodes, and one contracted sphere or plane test that turns a grazing child
# ray's self-hit forks it.
KERNEL_FLAGS = {KERNEL_TREE: ("-fmad=false",),
                KERNEL_RING: ("-fmad=false",)}

# the kernels of csrc/ring_shade.cu, each counted apart too
RING_KERNELS = ("ring_start", "ring_shadow", "ring_rows", "ring_finish")

# kernel launches in this process, per kernel source, and for the ring's
# source also per kernel: a wrapper adds one where it launches its kernel
# and nowhere else (chip_smoke.py resets and reads them to show that a run
# went through the kernels)
LAUNCHES = {k: 0 for k in KERNELS + RING_KERNELS}

# one lock per kernel, so that kernels build in parallel threads
_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_libs: dict[str, ctypes.CDLL] = {}
# compiler output (ptxas register and spill report) of each fresh build
build_logs: dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"kernel build failed: nvcc not found under {home}/bin or on PATH")
    return found


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to, named by a hash of every CUDA
    source in ``csrc/`` and of the kernel's flags."""
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        if not fname.endswith((".cu", ".cuh")):
            continue  # the host encoder (io/native.py) builds apart
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def nvcc_flags(name: str) -> tuple[str, ...]:
    """The nvcc flags ``csrc/<name>.cu`` is compiled with."""
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def _compile(name: str, so: str) -> None:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *nvcc_flags(name), "-o", tmp, src]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise KernelBuildError(
            f"kernel build failed ({' '.join(cmd)}):\n{r.stderr}")
    build_logs[name] = r.stdout + r.stderr
    os.replace(tmp, so)  # atomic: concurrent builders never see a partial file


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        lib = _libs.get(name)
        if lib is None:
            so = library_path(name)
            if not os.path.exists(so):
                _compile(name, so)
            lib = _libs[name] = ctypes.CDLL(so)
        return lib


def loaded() -> list[str]:
    """Names of the kernel libraries loaded in this process."""
    return sorted(_libs)
