"""device.idle.train_prithvi: the share of the Prithvi member's traced
steps' window in which no kernel, copy or set ran on the card."""

from port_bench.harness.readers import idle_pct


def read(record):
    return idle_pct(record, "train_epoch_prithvi")
