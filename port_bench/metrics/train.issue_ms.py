"""train.issue_ms: host milliseconds a step spends issuing its work, with
no profiler: the sum of the medians of the program's spans step.forward,
step.backward and step.optimizer in its registry (utils/profiling.py's
SPANS; the window's untraced steps are most of their durations)."""

from port_bench.harness.program_spans import registry_value


def read(record):
    return registry_value(record, ("step.forward", "step.backward", "step.optimizer"),
                          "median_ms")
