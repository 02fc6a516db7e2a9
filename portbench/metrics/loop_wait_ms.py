"""loop_wait_ms: the main loop's block on the previous batch's flush
before it hands a batch to the flush thread, ms a window batch
(BatchMetrics.wait_s)."""

from portbench import counters


def read(rec):
    return counters.mean_ms(rec, "wait_s")
