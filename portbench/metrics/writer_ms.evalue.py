"""writer_ms.evalue: the e-values' ms inside the m8 writer's columns, a
window batch (BatchMetrics.evalue_s)."""

from portbench import counters


def read(rec):
    return counters.mean_ms(rec, "evalue_s")
