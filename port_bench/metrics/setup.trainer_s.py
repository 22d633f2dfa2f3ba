"""setup.trainer_s: seconds of set-up spent constructing the Trainer (its
datasets, the feed with its cost gate and resident upload, the weights
and the resume): the total of the program's span trainer.init in its
registry (utils/profiling.py's SPANS)."""

from port_bench.harness.program_spans import registry_value


def read(record):
    return registry_value(record, ("trainer.init",), "total_s")
