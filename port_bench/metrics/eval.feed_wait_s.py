"""eval.feed_wait_s: seconds a map's main thread waits on a season read
(the program's timings['feed_wait_s']), the mean over the maps."""


def read(record):
    if record.get("driver") != "eval_map" or not record["units"]:
        return None
    units = record["units"]
    return sum(u["timings"]["feed_wait_s"] for u in units) / len(units)
