"""1 - the device's busy seconds over the traced window's; it serves every
``device_idle.<cells>`` metric."""

from benchmark.readers import idle as read  # noqa: F401
