"""train.feed_wait_ms: milliseconds the trainer waits on its feed's epoch
iterator for a batch, the mean over the window's batches."""


def read(record):
    waits = record.get("feed_waits_s") if record.get("driver") == "train_epoch" else None
    if not waits:
        return None
    return 1e3 * sum(waits) / len(waits)
