"""writer_ms.names: the batch's read-name arena's ms inside the m8
writer's formatting, a window batch (BatchMetrics.names_s)."""

from portbench import counters


def read(rec):
    return counters.mean_ms(rec, "names_s")
