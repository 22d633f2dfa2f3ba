"""mfu.train: the useful FLOPs of the window's steps, counted over each
sample's crop pixels and not its padding (roofline/flops.py's training
count: the trainable path three times, the frozen extractor once), per
second of the window, as a share of the card's published dense bf16 peak."""

from port_bench.roofline.flops import peak_flops, train_step_flops


def read(record):
    if record.get("driver") != "train_epoch" or not record["crop_px"]:
        return None
    peak = peak_flops(record["device_name"], "bf16")
    if peak is None:
        return None
    flops = train_step_flops(1, 1, 1) * sum(record["crop_px"])
    return 100.0 * flops / record["window_s"] / peak
