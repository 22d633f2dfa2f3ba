"""mfu.eval: the useful FLOPs of the window's patches (the building
extractor once and every member, roofline/flops.py) per second of the
window, as a share of the card's published dense bf16 peak."""

from port_bench.roofline.flops import eval_patch_flops, peak_flops


def read(record):
    if record.get("driver") != "eval_map" or record["n_patches"] == 0:
        return None
    peak = peak_flops(record["device_name"], "bf16")
    if peak is None:
        return None
    cfg = record["config"]
    flops = eval_patch_flops(cfg["patchsize"], cfg["patchsize"], cfg["members"]) * record["n_patches"]
    return 100.0 * flops / record["window_s"] / peak
