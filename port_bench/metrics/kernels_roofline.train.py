"""kernels_roofline.train: the fused kernels' share of their roofline over
the traced steps: the frozen extractor's blocks (and the member's where a
memory tier freezes its UNet), the training head and its backward, each
launch's least time (roofline/bounds.py) over the device time of the
kernels that made them (roofline/kernels.json)."""

from port_bench.harness.readers import roofline_pct
from port_bench.roofline.bounds import train_step_launches


def read(record):
    if record.get("driver") != "train_epoch" or not record.get("traced"):
        return None
    limit2 = record["config"]["train"]["limit2"]
    launches = []
    for b, h, w in record["traced"]:
        launches += train_step_launches(b, h, w, b * h * w > limit2)
    return roofline_pct(record, launches)
