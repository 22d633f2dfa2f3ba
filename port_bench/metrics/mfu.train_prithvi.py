"""mfu.train_prithvi: the useful FLOPs of the window's steps of the
Prithvi member, counted over each sample's crop tokens and pixels and not
the bucket's padding (roofline/flops_prithvi.py: the encoder three times
where it trains and once where a memory tier froze it, the neck likewise,
the head three times, the building extractor once), per second of the
window, as a share of the card's published dense bf16 peak."""

from port_bench.roofline.flops import peak_flops
from port_bench.roofline.flops_prithvi import sample_flops


def read(record):
    if record.get("driver") != "train_epoch_prithvi" or not record.get("samples_hw"):
        return None
    peak = peak_flops(record["device_name"], "bf16")
    if peak is None:
        return None
    cfg, tr = record["config"], record["config"]["train"]
    flops = 0.0
    for ((b, h, w), _), hws in zip(record["units"], record["samples_hw"]):
        px = b * h * w
        flops += sum(sample_flops(cfg, sh, sw, px > tr["limit1"], px > tr["limit2"])
                     for sh, sw in hws)
    return 100.0 * flops / record["window_s"] / peak
