"""device_idle_pct: the device's idle share of the profiled stretch
(readers.device_idle_pct)."""

from portbench.readers import device_idle_pct as read  # noqa: F401
