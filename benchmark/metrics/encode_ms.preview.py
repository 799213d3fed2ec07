"""Median host milliseconds of the benchmark's call into the encode (clip,
``color.to_srgb``, ``bmp.header`` and ``bmp.encode_rows``) over the traced
run's requests."""

import numpy as np


def read(run):
    times = run.window.encode_s
    return float(np.median(times)) * 1e3 if times else None
