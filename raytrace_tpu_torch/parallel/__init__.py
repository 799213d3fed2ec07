"""Parallelism: ranks and their devices, pixel-sharded and multi-process
rendering, gradient all-reduce, object-sharded ring intersection.

PyTorch counterpart of :mod:`raytrace_tpu.parallel`, on
``torch.distributed``: one process per rank, each on one device.  Pixels
are the big data-parallel axis, scene parameters are replicated with
their gradients all-reduced, and very large scenes can shard their
objects around a ring of ranks (a minimum over circulating hit records).
Importing these modules starts no process group and builds no kernel.
"""
