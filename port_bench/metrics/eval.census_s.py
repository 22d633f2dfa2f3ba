"""eval.census_s: seconds a map spends outside the sliding window (the
device census at both levels, the dasymmetric adjustment and their
reads): the host clock around test_target minus the window's total_s,
the mean over the maps of the run."""


def read(record):
    if record.get("driver") != "eval_map" or not record["units"]:
        return None
    units = record["units"]
    return sum(u["wall_s"] - u["timings"]["total_s"] for u in units) / len(units)
