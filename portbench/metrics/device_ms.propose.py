"""device_ms.propose: device ms a batch under the propose range
(readers.device_ms)."""

from portbench import readers


def read(rec):
    return readers.device_ms(rec, "propose")
