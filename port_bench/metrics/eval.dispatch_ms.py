"""eval.dispatch_ms: host milliseconds spent issuing a patch's work (crop,
the members' forward, the stitch) with the device behind it: the
program's timings['dispatch_s'] over its n_patches, over the run."""


def read(record):
    if record.get("driver") != "eval_map":
        return None
    n = sum(u["timings"]["n_patches"] for u in record["units"])
    if n == 0:
        return None
    return 1e3 * sum(u["timings"]["dispatch_s"] for u in record["units"]) / n
