"""device.idle.train: the share of the traced steps' window in which no
kernel, copy or set ran on the card."""

from port_bench.harness.readers import idle_pct


def read(record):
    return idle_pct(record, "train_epoch")
