"""kernels_roofline.eval: the fused kernels' share of their roofline over
the traced maps: the least time of every launch those maps make
(roofline/bounds.py) over the device time of the kernels that made them
(roofline/kernels.json), summed over the functions the trace shows."""

from port_bench.harness.readers import roofline_pct
from port_bench.roofline.bounds import eval_patch_launches


def read(record):
    if record.get("driver") != "eval_map" or not record.get("traced"):
        return None
    cfg = record["config"]
    n = sum(u["timings"]["n_patches"] for u in record["traced"])
    return roofline_pct(record, eval_patch_launches(cfg["patchsize"], cfg["members"]) * n)
