"""kernels_roofline.adam: the update's share of its roofline over the
traced steps of the Prithvi member: 28 bytes a trained parameter and the
clip's norm's read of the gradient, 4 more (roofline/flops_prithvi.py),
at the card's HBM bandwidth, once a step, over the device time of the
update's kernels (csrc/adam.cu, roofline/kernels_prithvi.json)."""

from port_bench.harness.readers import roofline_pct
from port_bench.roofline.flops_prithvi import adam_bytes


def read(record):
    if record.get("driver") != "train_epoch_prithvi" or not record.get("traced_samples"):
        return None
    launches = [("adam", 0.0, adam_bytes(record["config"]), "bf16")] * len(record["traced_samples"])
    tr = record.get("trace_prithvi")
    return None if not tr else roofline_pct({**record, "trace": tr}, launches)
