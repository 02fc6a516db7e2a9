"""device_ms.align: device ms a batch under the align range
(readers.device_ms)."""

from portbench import readers


def read(rec):
    return readers.device_ms(rec, "align")
