"""Closest-hit rounds of the window's finished images over its seconds
(``yardstick.counts.ray_counts``: a primary sample takes max_depth + 2)."""


def read(run):
    w = run.window
    return w.rays / w.elapsed if w.rays and w.elapsed > 0 else None
