"""queue_ms: a batch's wait from the end of its step to the start of
its flush, ms a window batch (BatchMetrics.queue_s)."""

from portbench import counters


def read(rec):
    return counters.mean_ms(rec, "queue_s")
