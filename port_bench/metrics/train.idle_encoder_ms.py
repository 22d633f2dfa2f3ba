"""train.idle_encoder_ms: milliseconds a traced step of the Prithvi member
in which no kernel, copy or set ran on the card while the program's span
``prithvi.encoder`` (its 24 blocks' forward, nn/prithvi.py) was the
innermost span over the idle gap; 0.0 where the trace's gaps name other
spans of the step and not this one, None where they name no span of the
step (a program without the span)."""

STEP_SPANS = ("step.forward", "step.backward", "step.optimizer", "prithvi.encoder",
              "prithvi.embed", "prithvi.neck")


def read(record):
    tr = record.get("trace")
    if record.get("driver") != "train_epoch_prithvi" or not tr or not record.get("traced"):
        return None
    gaps = dict(tr["idle_gaps"])
    if not any(n in gaps for n in STEP_SPANS):
        return None
    return 1e3 * gaps.get("prithvi.encoder", 0.0) / len(record["traced"])
