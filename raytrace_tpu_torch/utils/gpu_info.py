"""What the card offers the kernels, read from the device.

PyTorch counterpart of :mod:`raytrace_tpu.utils.tpu_info`, which sizes the
JAX package's kernels from the TPU's VMEM.  Here :func:`card` reads what
the runtime reports of a CUDA device (``torch.cuda.get_device_properties``):
its SMs, shared memory per SM and per block, registers and threads per SM,
L2.  :func:`peaks` gives the published peak rates of a card it knows by
name, with their source, and raises for any other: it does not guess.
Every function takes a properties object (or the :class:`Card` made from
one), so that the tests can hand it an H100's figures on the CPU.

Users: :func:`fold_shared_max_bytes` sizes the table fold's staging in
shared memory (``ops/intersect_scan.py``); ``utils/flops.py`` makes the
kernels' bounds from :func:`peaks`.
"""

from __future__ import annotations

import dataclasses

# shared memory that the runtime reserves for each resident block on
# compute capability 8.0 and later (CUDA C++ Programming Guide, "Shared
# Memory" of compute capability 9.0; cudaDevAttrReservedSharedMemoryPerBlock)
RESERVED_SHARED_PER_BLOCK = 1024
# registers are allocated to a warp in units of 256, so a thread's count
# is rounded up to a multiple of 8
REGISTER_UNIT = 8


@dataclasses.dataclass(frozen=True)
class Card:
    """What the runtime reports of one CUDA device."""

    name: str
    sm_count: int
    shared_per_sm: int           # bytes, all the blocks of an SM together
    shared_per_block_optin: int  # bytes, the most one block may ask for
    regs_per_sm: int             # 32-bit registers
    max_threads_per_sm: int
    l2_bytes: int


def card(props) -> Card:
    """The :class:`Card` of a ``torch.cuda.get_device_properties`` object
    (or anything with its attribute names)."""
    try:
        return Card(name=props.name, sm_count=props.multi_processor_count,
                    shared_per_sm=props.shared_memory_per_multiprocessor,
                    shared_per_block_optin=props.shared_memory_per_block_optin,
                    regs_per_sm=props.regs_per_multiprocessor,
                    max_threads_per_sm=props.max_threads_per_multi_processor,
                    l2_bytes=props.L2_cache_size)
    except AttributeError as e:
        raise RuntimeError(f"this PyTorch does not report {e.name} of a "
                           f"CUDA device") from e


def device_card(device=None) -> Card:
    """The :class:`Card` of a CUDA device (the current one by default)."""
    import torch

    return card(torch.cuda.get_device_properties(device))


@dataclasses.dataclass(frozen=True)
class Peaks:
    """Published peak rates of one card, at its full power limit."""

    name: str
    fp32_flops: float   # FP32 outside the tensor cores, a fused multiply-add two
    mem_bytes: float    # device memory, bytes per second
    boost_hz: float     # the SM clock the rates assume
    sm_count: int
    source: str
    # per SM and clock on compute capability 9.0 (CUDA C++ Programming
    # Guide, arithmetic instruction throughput): special-function operations
    # (reciprocal, square root, sine, cosine, logarithm, exponential) and
    # 32-bit integer adds, multiplies, shifts or logical operations
    sfu_per_sm_clock: int = 16
    int_per_sm_clock: int = 64

    @property
    def sfu_ops(self) -> float:
        return self.sm_count * self.sfu_per_sm_clock * self.boost_hz

    @property
    def int_ops(self) -> float:
        return self.sm_count * self.int_per_sm_clock * self.boost_hz


H100_SXM = Peaks(
    name="NVIDIA H100 SXM", fp32_flops=67e12, mem_bytes=3.35e12,
    boost_hz=1.98e9, sm_count=132,
    source="NVIDIA H100 Tensor Core GPU data sheet, SXM5: FP32 67 TFLOP/s, "
           "80 GB HBM3 at 3.35 TB/s; 132 SMs at a 1,980 MHz boost clock")


def peaks(props) -> Peaks:
    """The published peaks of the card ``props`` describes (a properties
    object, a :class:`Card` or a device name).  An H100 SXM names itself
    ``NVIDIA H100 80GB HBM3``; a card of another name, or of that name with
    another SM count, raises ``LookupError``."""
    name = props if isinstance(props, str) else props.name
    sms = None if isinstance(props, str) else getattr(
        props, "sm_count", getattr(props, "multi_processor_count", None))
    if "H100" in name and ("HBM3" in name or "SXM" in name) and (
            sms in (None, H100_SXM.sm_count)):
        return H100_SXM
    raise LookupError(f"no published peaks for {name!r} ({sms} SMs): the "
                      f"bounds know only the {H100_SXM.name}")


def resident_blocks(c: Card, regs_per_thread: int, threads: int) -> int:
    """Blocks of ``threads`` threads at ``regs_per_thread`` registers that
    an SM holds at once, by registers and by threads (shared memory
    aside)."""
    regs = -(-regs_per_thread // REGISTER_UNIT) * REGISTER_UNIT
    return min(c.regs_per_sm // (regs * threads),
               c.max_threads_per_sm // threads)


def fold_shared_max_bytes(c: Card, regs_per_thread: int,
                          threads: int = 256) -> int:
    """The most shared memory a block of a fold kernel may stage its table
    in (with whatever else it keeps there) and still leave the SM all the
    blocks that the kernel's registers allow: the SM's shared memory shared
    among those blocks, less what the runtime reserves for each, rounded
    down to a whole KB.  On an H100 (228 KB an SM) at 48 registers, five
    blocks of 256 threads: 44 KB."""
    blocks = max(resident_blocks(c, regs_per_thread, threads), 1)
    share = c.shared_per_sm // blocks - RESERVED_SHARED_PER_BLOCK
    return min(share // 1024 * 1024, c.shared_per_block_optin)


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    first card's line): a card may be set below its full power, and then
    runs slower under load, so every time taken on it carries this."""
    import subprocess

    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], check=True,
                       capture_output=True, text=True, timeout=60)
    return r.stdout.strip().splitlines()[0]
