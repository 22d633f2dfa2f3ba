"""Profiling and device-memory observability.

Counterpart of popcorn_tpu/utils/profiling.py: the reference's nvidia-smi
memory probe (run_train.py:39-40, 156-158), read from PyTorch's CUDA
caching allocator; ``torch.profiler`` traces in the Chrome trace format
(viewable in Perfetto or chrome://tracing); and the section timer that
carries the program's spans.

A span (``span(name)``) adds the host seconds of a section to the
process-wide ``SPANS`` and, while a ``torch.profiler`` session records,
also marks the section in the trace (``record_function``), on the clock
of the kernels. Spans go on the thread that drives the step: a trace
reader that names the device's idle by the innermost span over it does
not tell threads apart.

A counter (``count(name, n)``) adds ``n`` to the process-wide
``COUNTERS``: what a section did rather than how long it took (tokens a
step's encoder attended, steps a memory tier froze, and each hand-written
kernel's launches as ``launches/<entry>``, nn/cuda_lib.py::launch).
Counters are process totals that only grow: a reader takes what they
added between two ``COUNTERS.summary()`` snapshots (``COUNTERS.since``).
The train CLI logs each epoch's span medians and counter differences,
and resets the spans.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import deque
from typing import Deque, Dict

import numpy as np
import torch


def device_memory_stats(device=None) -> Dict[str, float]:
    """Bytes allocated now, the card's total and the peak allocated since
    the last ``torch.cuda.reset_peak_memory_stats``, in GB. Returns {} for
    a CPU device."""
    dev = torch.device(device) if device is not None else None
    if dev is None:
        if not torch.cuda.is_available():
            return {}
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cuda":
        return {}
    return {
        "mem_used_gb": torch.cuda.memory_allocated(dev) / 1e9,
        "mem_limit_gb": torch.cuda.get_device_properties(dev).total_memory / 1e9,
        "mem_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace context: ``with trace('/tmp/trace'): step()``
    writes ``logdir/trace.json``, the CPU operators and, with a card, its
    kernels."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class _Section:
    """One timed section of a Stopwatch (``Stopwatch.section``)."""

    __slots__ = ("watch", "name", "t0", "rf")

    def __init__(self, watch: "Stopwatch", name: str):
        self.watch, self.name, self.rf = watch, name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.watch.add(self.name, time.perf_counter() - self.t0)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


class Stopwatch:
    """Accumulating section timer: each name's total seconds and count, and
    its last ``keep`` durations for a median and a 95th percentile (memory
    stays bounded over a long training). Safe to add to from any thread."""

    keep = 4096

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.recent: Dict[str, Deque[float]] = {}
        self._lock = threading.Lock()

    def section(self, name: str) -> _Section:
        """``with watch.section(name):`` times the block, also when it
        raises; under a recording profiler the block is a
        ``record_function`` span too."""
        return _Section(self, name)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds
            self.counts[name] = self.counts.get(name, 0) + 1
            if name not in self.recent:
                self.recent[name] = deque(maxlen=self.keep)
            self.recent[name].append(seconds)

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()
            self.recent.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{name: {total_s, count, mean_s, and median_ms and p95_ms over the
        last ``keep`` durations}}."""
        with self._lock:
            items = [(n, t, self.counts[n], list(self.recent[n])) for n, t in self.totals.items()]
        out = {}
        for name, t, n, recent in items:
            med, p95 = np.percentile(recent, [50, 95])
            out[name] = {"total_s": t, "count": n, "mean_s": t / n,
                         "median_ms": 1e3 * float(med), "p95_ms": 1e3 * float(p95)}
        return out


# the program's spans (module docstring)
SPANS = Stopwatch()


def span(name: str) -> _Section:
    """A section of the process-wide ``SPANS``: ``with span("step.forward"):``."""
    return SPANS.section(name)


class Counters:
    """Accumulating named counts that only grow. Safe to add to from any
    thread."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self._lock = threading.Lock()

    def add(self, name: str, n: float = 1) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0) + n

    def summary(self) -> Dict[str, float]:
        with self._lock:
            return dict(self.totals)

    def since(self, before: Dict[str, float], prefix: str = "") -> Dict[str, float]:
        """What each counter named ``prefix``... added since the snapshot
        ``before`` (a ``summary()``): {name: difference}, the counters that
        grew only."""
        return {k: v - before.get(k, 0) for k, v in self.summary().items()
                if k.startswith(prefix) and v != before.get(k, 0)}


# the program's counters (module docstring)
COUNTERS = Counters()


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the process-wide counter ``name``."""
    COUNTERS.add(name, n)
