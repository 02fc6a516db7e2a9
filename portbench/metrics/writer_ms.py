"""writer_ms: the m8 writer's host ms a window batch (readers.writer_ms)."""

from portbench.readers import writer_ms as read  # noqa: F401
