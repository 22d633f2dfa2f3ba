"""kernels_roofline.attention: attention's share of its roofline over the
traced steps of the Prithvi member: each sample's least time at the bf16
peak, 4 N^2 D FLOPs a block forward and 8 N^2 D backward where the encoder
trains (N its tokens, roofline/flops_prithvi.py), over the device time of
the fused attention kernels (roofline/kernels_prithvi.json)."""

from port_bench.harness.readers import roofline_pct
from port_bench.roofline.flops_prithvi import attention_flops, tokens


def read(record):
    if record.get("driver") != "train_epoch_prithvi" or not record.get("traced_samples"):
        return None
    cfg, launches = record["config"], []
    for hws, frozen in zip(record["traced_samples"], record["traced_frozen"]):
        for h, w in hws:
            fl = attention_flops(cfg, tokens(cfg, h, w))
            launches.append(("attention_fwd", fl, 0.0, "bf16"))
            if not frozen:
                launches.append(("attention_bwd", 2 * fl, 0.0, "bf16"))
    tr = record.get("trace_prithvi")
    return None if not tr else roofline_pct({**record, "trace": tr}, launches)
