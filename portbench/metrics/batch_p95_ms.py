"""batch_p95_ms: 95th percentile of a window batch's launch to rows written
(readers.batch_p95_ms)."""

from portbench.readers import batch_p95_ms as read  # noqa: F401
