"""device_ms.refine: device ms a batch under the refine range
(readers.device_ms)."""

from portbench import readers


def read(rec):
    return readers.device_ms(rec, "refine")
