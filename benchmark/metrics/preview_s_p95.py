"""95th percentile of the wall seconds of every preview in the window."""

from benchmark.readers import p95 as read  # noqa: F401
