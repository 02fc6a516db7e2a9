"""reads_per_s: reads written over the window (readers.reads_per_s)."""

from portbench.readers import reads_per_s as read  # noqa: F401
