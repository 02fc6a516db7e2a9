"""engine_reads_per_s: reads a second of the engine step alone
(readers.engine_reads_per_s)."""

from portbench.readers import engine_reads_per_s as read  # noqa: F401
