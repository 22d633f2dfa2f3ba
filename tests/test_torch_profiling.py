"""utils/profiling.py of the port (tests/test_utils_aux.py's cases for
popcorn_tpu/utils/profiling.py): the section timer, the torch.profiler
trace context writing its Chrome trace on the CPU, and the memory probe
that reads nothing without a card."""

import json
import os

import torch

from popcorn_tpu_torch.utils.profiling import Stopwatch, device_memory_stats, trace


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
