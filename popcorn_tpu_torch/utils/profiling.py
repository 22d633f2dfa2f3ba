"""Profiling and device-memory observability.

Counterpart of popcorn_tpu/utils/profiling.py: the reference's nvidia-smi
memory probe (run_train.py:39-40, 156-158), read from PyTorch's CUDA
caching allocator; ``torch.profiler`` traces in the Chrome trace format
(viewable in Perfetto or chrome://tracing); and a coarse section timer.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

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


class Stopwatch:
    """Accumulating section timer for coarse pipeline profiling."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {
            name: {"total_s": t, "count": self.counts[name], "mean_s": t / self.counts[name]}
            for name, t in self.totals.items()
        }
