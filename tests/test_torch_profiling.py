"""utils/profiling.py of the port (tests/test_utils_aux.py's cases for
popcorn_tpu/utils/profiling.py): the section timer, the torch.profiler
trace context writing its Chrome trace on the CPU, and the memory probe
that reads nothing without a card; then the program's spans: the
registry's bounded window, a record_function only under a profiler, the
spans in a trace, and the train path's spans over a CPU epoch."""

import json
import os

import numpy as np
import pytest
import torch

from popcorn_tpu_torch.utils.profiling import SPANS, Stopwatch, device_memory_stats, span, trace


def test_stopwatch_and_memstats():
    sw = Stopwatch()
    with sw.section("a"):
        sum(range(1000))
    with sw.section("a"):
        pass
    s = sw.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_s"] >= 0
    assert s["a"]["mean_s"] == s["a"]["total_s"] / 2
    # a CPU device has no allocator statistics -> {}
    assert device_memory_stats("cpu") == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32))
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


def _annotations(logdir):
    with open(os.path.join(logdir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def test_span_registry_keeps_a_bounded_window():
    SPANS.reset()
    with span("a"):
        pass
    SPANS.add("a", 0.003)
    s = SPANS.summary()["a"]
    assert s["count"] == 2 and s["total_s"] >= 0.003
    sw = Stopwatch()
    for i in range(5000):
        sw.add("b", i * 1e-3)
    s = sw.summary()["b"]
    assert len(sw.recent["b"]) == 4096 == sw.keep
    assert s["count"] == 5000
    # the last 4096 durations, 904 .. 4999 ms
    assert s["median_ms"] == pytest.approx(np.percentile(np.arange(904, 5000), 50))
    assert s["p95_ms"] == pytest.approx(np.percentile(np.arange(904, 5000), 95))
    sw.reset()
    assert sw.summary() == {} and not sw.recent
    SPANS.reset()
    assert SPANS.summary() == {}


def test_span_closes_on_an_exception():
    SPANS.reset()
    with pytest.raises(FloatingPointError):
        with span("raises"):
            raise FloatingPointError("detected NaN loss..")
    assert SPANS.summary()["raises"]["count"] == 1
    SPANS.reset()


def test_span_makes_a_record_function_only_under_a_profiler(monkeypatch):
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    for _ in range(3):
        with span("quiet"):
            pass
    assert made == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("loud"):
            pass
    assert made == ["loud"]
    SPANS.reset()


def test_span_lands_in_the_trace_as_a_user_annotation(tmp_path):
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        with span("outer.x"):
            with span("inner.y"):
                torch.matmul(torch.ones(16, 16), torch.ones(16, 16))
        with pytest.raises(ValueError):
            with span("raised.z"):
                raise ValueError
    ann = {e["name"]: e for e in _annotations(logdir)}
    assert {"outer.x", "inner.y", "raised.z"} <= set(ann)
    o, i = ann["outer.x"], ann["inner.y"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    SPANS.reset()


STEP_SPANS = ("step.forward", "step.backward", "step.optimizer")


@pytest.fixture(scope="module")
def small_trainer(tmp_path_factory):
    from popcorn_tpu_torch.config import DataPaths, ModelConfig, TrainConfig
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region
    from popcorn_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    root = str(tmp_path_factory.mktemp("popdata_spans"))
    make_synthetic_region(root, "rwa", height=256, width=384, n_regions=(3, 4), seed=11)
    tcfg = TrainConfig(num_epochs=1, bucket_ladder=(512,), logstep_train=1, max_samples=4,
                       num_workers=1, save_dir=str(tmp_path_factory.mktemp("outputs")),
                       val_every_n_epochs=100)
    SPANS.reset()
    trainer = Trainer(DataPaths(root), ModelConfig(biasinit=0.9407), tcfg,
                      inference_patch=128, inference_overlap=16, device="cpu")
    init = SPANS.summary()
    return trainer, init


def test_trainer_construction_is_one_span(small_trainer):
    _, init = small_trainer
    assert init["trainer.init"]["count"] == 1
    assert init["trainer.init.feed"]["count"] == init["trainer.init.model"]["count"] == 1
    inner = init["trainer.init.feed"]["total_s"] + init["trainer.init.model"]["total_s"]
    assert inner <= init["trainer.init"]["total_s"]


def test_a_traced_epoch_holds_the_train_path_spans(small_trainer, tmp_path):
    trainer, _ = small_trainer
    SPANS.reset()
    it0 = trainer.info["iter"]
    logdir = str(tmp_path / "trace")
    with trace(logdir):
        trainer.train_epoch()
    steps = trainer.info["iter"] - it0
    assert steps == 2
    ann = sorted(_annotations(logdir), key=lambda e: e["ts"])
    names = [e["name"] for e in ann]
    for name in ("trainer.upload", "trainer.readback") + STEP_SPANS:
        assert names.count(name) == steps, (name, names)
    # a wait a batch, and the wait that ends the epoch
    assert names.count("feed.batch") == steps + 1
    # the step's three phases in order, none overlapping the next
    phases = [e for e in ann if e["name"] in STEP_SPANS]
    assert [e["name"] for e in phases] == list(STEP_SPANS) * steps
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    # the host registry counts what the trace shows
    s = SPANS.summary()
    for name in ("trainer.upload", "trainer.readback") + STEP_SPANS:
        assert s[name]["count"] == steps
    SPANS.reset()


def test_train_logs_each_span_median_and_resets(small_trainer):
    trainer, _ = small_trainer
    SPANS.reset()
    trainer.train()
    with open(os.path.join(trainer.experiment_folder, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    times = [r for r in recs if "time/step.forward_ms" in r]
    assert len(times) == 1
    for name in ("feed.batch", "trainer.upload", "trainer.readback") + STEP_SPANS:
        assert times[0][f"time/{name}_ms"] > 0
    # the optimizer kernel's launches of the epoch: none on the CPU
    assert times[0]["launches/adam"] == 0
    assert SPANS.summary() == {}


def test_stopwatch_adds_from_many_threads_lose_nothing():
    import sys
    import threading

    sw = Stopwatch()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                with sw.section("t"):
                    pass
                sw.add("u", 1.0)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    s = sw.summary()
    assert s["t"]["count"] == s["u"]["count"] == 32000
    assert s["u"]["total_s"] == 32000.0 and len(sw.recent["u"]) == sw.keep == 4096
