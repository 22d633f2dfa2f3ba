"""The readers of the program's own spans on the CPU: None on a record of a
program without spans (the benchmark's own span names alone, no
registry), the expected milliseconds where the program's spans are
there and 0.0 for a phase that named no gap, through harness/trace.py's
reduction of a hand-made trace too; and the train path's span names with
the benchmark's own stay within the ten idle gaps that reduction keeps."""

import ast
import json
import os

import pytest

from port_bench.harness import program_spans, spec
from port_bench.harness.trace import reduce_trace

IDLE = ("train.idle_forward_ms", "train.idle_backward_ms", "train.idle_optimizer_ms")
REGISTRY = ("train.issue_ms", "train.readback_wait_ms", "setup.trainer_s")
NEW = IDLE + REGISTRY
# the spans the benchmark's driver and trace name gaps by
BENCH_GAPS = ("train.step_fn", "train.feed_next", "outside the benchmark's spans")


def _read(name, record):
    return spec.metric_reader(name)(record)


def _record(gaps, steps=18):
    return {"driver": "train_epoch", "traced": [(2, 512, 512)] * steps,
            "trace": {"window_s": 1.0, "busy_s": 0.5, "idle_gaps": [list(g) for g in gaps]}}


class _Summary:
    def __init__(self, summary):
        self._s = summary

    def summary(self):
        return self._s


def test_the_new_metrics_are_in_the_benchmark():
    got = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in NEW:
        assert got[name]["workloads"] == ["train-member-resident"]
        assert got[name]["unit"] == ("s" if name == "setup.trainer_s" else "ms")


def test_a_program_without_spans_reads_none(monkeypatch):
    from popcorn_tpu_torch.utils import profiling

    parent = _record([("train.step_fn", 0.485), ("outside the benchmark's spans", 0.053),
                      ("train.feed_next", 0.009)])
    monkeypatch.delattr(profiling, "SPANS")
    for name in NEW:
        assert _read(name, parent) is None, name
    # no trace at all, and another driver
    for name in IDLE:
        assert _read(name, {"driver": "train_epoch", "traced": []}) is None
    assert _read("train.issue_ms", {"driver": "eval_map"}) is None


def test_a_registry_without_the_names_reads_none(monkeypatch):
    from popcorn_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "SPANS", _Summary({"step.forward": {"median_ms": 1.0}}))
    for name in REGISTRY:
        assert _read(name, _record([])) is None, name


def test_idle_under_each_phase_a_traced_step():
    rec = _record([("step.optimizer", 0.18), ("step.backward", 0.09), ("train.step_fn", 0.018),
                   ("trainer.readback", 0.02), ("outside the benchmark's spans", 0.01)])
    assert _read("train.idle_optimizer_ms", rec) == pytest.approx(10.0)
    assert _read("train.idle_backward_ms", rec) == pytest.approx(5.0)
    # a phase that named no gap reads 0, not None
    assert _read("train.idle_forward_ms", rec) == 0.0


def test_registry_readers(monkeypatch):
    from popcorn_tpu_torch.utils import profiling

    s = {"step.forward": {"median_ms": 9.5, "total_s": 12.0},
         "step.backward": {"median_ms": 11.0, "total_s": 14.0},
         "step.optimizer": {"median_ms": 14.5, "total_s": 18.0},
         "trainer.readback": {"median_ms": 2.25, "total_s": 3.0},
         "trainer.init": {"median_ms": 4200.0, "total_s": 4.2}}
    monkeypatch.setattr(profiling, "SPANS", _Summary(s))
    rec = _record([])
    assert _read("train.issue_ms", rec) == pytest.approx(35.0)
    assert _read("train.readback_wait_ms", rec) == pytest.approx(2.25)
    assert _read("setup.trainer_s", rec) == pytest.approx(4.2)


def test_the_program_registry_is_read(monkeypatch):
    """The readers take the program's real registry in this process."""
    from popcorn_tpu_torch.utils import profiling

    w = profiling.Stopwatch()
    for name, ms in (("step.forward", 4), ("step.backward", 5), ("step.optimizer", 6),
                     ("trainer.readback", 1), ("trainer.init", 3000)):
        w.add(name, ms * 1e-3)
    monkeypatch.setattr(profiling, "SPANS", w)
    assert _read("train.issue_ms", _record([])) == pytest.approx(15.0)
    assert _read("setup.trainer_s", _record([])) == pytest.approx(3.0)


def test_through_the_trace_reduction(tmp_path):
    """A hand-made trace of one step: the gaps are named by the innermost
    span over their middle, the program's inside the benchmark's."""
    ann = [("bench.unit", 0, 1000), ("train.step_fn", 0, 900), ("step.forward", 0, 300),
           ("step.backward", 300, 300), ("step.optimizer", 600, 300),
           ("trainer.readback", 900, 100)]
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": t, "dur": d} for n, t, d in ann]
    # busy 100-300 (forward), 400-600 (backward), 880-900 (optimizer),
    # 950-1000 (readback), in microseconds
    ev += [{"ph": "X", "cat": "kernel", "name": f"k{i}", "ts": a, "dur": b - a}
           for i, (a, b) in enumerate(((100, 300), (400, 600), (880, 900), (950, 1000)))]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    tr = reduce_trace(str(p), {})
    rec = {"driver": "train_epoch", "traced": [(2, 256, 256)], "trace": tr}
    # idle: 0-100 (forward), 300-400 (backward), 600-880 (optimizer), 900-950
    assert _read("train.idle_forward_ms", rec) == pytest.approx(0.1)
    assert _read("train.idle_backward_ms", rec) == pytest.approx(0.1)
    assert _read("train.idle_optimizer_ms", rec) == pytest.approx(0.28)
    assert dict(tr["idle_gaps"])["trainer.readback"] == pytest.approx(50e-6)


def _program_spans(path):
    """The names of ``span("...")`` calls in a program file."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    return {n.args[0].value for n in ast.walk(tree)
            if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "span"
            and n.args and isinstance(n.args[0], ast.Constant)}


def test_the_train_path_spans_fit_the_kept_gaps():
    pkg = os.path.join(spec.ROOT, "popcorn_tpu_torch")
    names = set()
    for rel in ("data/feed.py", "train/trainer.py", "train/state.py"):
        names |= _program_spans(os.path.join(pkg, rel))
    # the Trainer's construction runs before any traced step
    traced = {n for n in names if not n.startswith("trainer.init")}
    assert traced == set(program_spans.TRAIN_SPANS)
    assert len(traced) + len(BENCH_GAPS) <= 10  # reduce_trace keeps the top 10 gaps
    assert {"trainer.init", "trainer.init.feed", "trainer.init.model"} <= names
