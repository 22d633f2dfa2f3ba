"""train.readback_wait_ms: host milliseconds the trainer waits for a step
it has issued (the loss, the counts and the logged values read back): the
median of the program's span trainer.readback in its registry
(utils/profiling.py's SPANS). Near 0, the step is bound by its issue."""

from port_bench.harness.program_spans import registry_value


def read(record):
    return registry_value(record, ("trainer.readback",), "median_ms")
