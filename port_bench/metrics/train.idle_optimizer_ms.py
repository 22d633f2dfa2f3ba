"""train.idle_optimizer_ms: milliseconds a traced step in which no kernel, copy
or set ran on the card while the program's span ``step.optimizer`` was the
innermost span over the idle gap (the trace's idle_gaps over the traced
steps)."""

from port_bench.harness.program_spans import idle_ms_per_step


def read(record):
    return idle_ms_per_step(record, "step.optimizer")
