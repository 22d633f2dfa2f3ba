"""What the readers of the program's own spans share. The program
(popcorn_tpu_torch/utils/profiling.py) times its train path in named
spans, keeps them in the process-wide registry ``SPANS`` and, under the
tracer's profiler, marks them in the trace, where harness/trace.py names
each idle gap by the innermost span over it. A program without spans
(no ``SPANS``, or no span of the train path in the trace) reads None."""

from __future__ import annotations

from typing import Dict, Optional

# the train path's spans, in the order of a step: the wait for the next
# batch, its upload, the step's three phases, the host's wait for the step
TRAIN_SPANS = ("feed.batch", "trainer.upload", "step.forward", "step.backward",
               "step.optimizer", "trainer.readback")


def idle_ms_per_step(record: Dict, name: str) -> Optional[float]:
    """Idle milliseconds a traced step under the span ``name``: 0.0 where
    other spans of the train path name gaps and this one none."""
    tr = record.get("trace")
    if record.get("driver") != "train_epoch" or not tr or not record.get("traced"):
        return None
    gaps = {n: s for n, s in tr["idle_gaps"]}
    if not any(n in gaps for n in TRAIN_SPANS):
        return None
    return 1e3 * gaps.get(name, 0.0) / len(record["traced"])


def registry_value(record: Dict, names, key: str) -> Optional[float]:
    """The sum of ``key`` over the spans ``names`` in the program's
    ``SPANS.summary()`` in this process; None where the program has no
    registry or any of the names is missing from it."""
    if record.get("driver") != "train_epoch":
        return None
    from popcorn_tpu_torch.utils import profiling

    spans = getattr(profiling, "SPANS", None)
    summary = None if spans is None else spans.summary()
    if summary is None or any(n not in summary for n in names):
        return None
    return sum(summary[n][key] for n in names)
