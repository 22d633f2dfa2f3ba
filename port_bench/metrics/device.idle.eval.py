"""device.idle.eval: the share of the traced maps' window in which no
kernel, copy or set ran on the card."""

from port_bench.harness.readers import idle_pct


def read(record):
    return idle_pct(record, "eval_map")
