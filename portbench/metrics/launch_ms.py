"""launch_ms: host ms a window batch inside search_refine_async_dna
(readers.launch_ms)."""

from portbench.readers import launch_ms as read  # noqa: F401
