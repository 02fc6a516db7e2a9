"""setup_s: readers.setup_s, reported by every cell."""

from portbench.readers import setup_s as read  # noqa: F401
