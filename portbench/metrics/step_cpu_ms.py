"""step_cpu_ms: the main thread's CPU ms in a window batch's step
(BatchMetrics.step_cpu_s); launch_ms less this is the step's wait for
the interpreter lock or the device."""

from portbench import counters


def read(rec):
    return counters.mean_ms(rec, "step_cpu_s")
