"""train.step_ms_p95: the 95th percentile of the milliseconds between
successive calls of the Trainer's step_fn over the window (the step, the
loss's read-back, the next batch's wait and upload; epoch boundaries
included)."""

import numpy as np


def read(record):
    if record.get("driver") != "train_epoch" or len(record["step_intervals_s"]) < 20:
        return None
    return 1e3 * float(np.percentile(record["step_intervals_s"], 95))
