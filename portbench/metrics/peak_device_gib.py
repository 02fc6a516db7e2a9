"""peak_device_gib: readers.peak_device_gib, reported by every cell."""

from portbench.readers import peak_device_gib as read  # noqa: F401
