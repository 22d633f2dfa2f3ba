"""The device trace of a traced run: a torch.profiler window over a few
units (maps or steps) that the driver runs after the measured window has
closed, so that the profiler's cost leaves the window's host clocks
alone, reduced to the numbers the per-layer readers take.

The window of the trace is the span of the benchmark's own
``bench.unit`` annotations; device busy time is the union of the
kernel, copy and set intervals inside it; an idle gap is named by the
innermost host annotation (``record_function`` span of this folder's
code) that covers its middle.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
UNIT_SPAN = "bench.unit"


class Tracer:
    """Profiles units 0 .. ``count - 1``: the driver calls ``unit_begin(i)``
    before unit i and ``unit_end(i)`` after it, until ``done``."""

    def __init__(self, count: int, out_path: str):
        self.count, self.out_path = count, out_path
        self.prof = None
        self._span = None
        self.done = False

    def unit_begin(self, i: int) -> None:
        if self.done:
            return
        if i == 0:
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
        if self.prof is not None:
            self._span = torch.autograd.profiler.record_function(UNIT_SPAN)
            self._span.__enter__()

    def unit_end(self, i: int) -> None:
        if self.prof is None or self.done:
            return
        torch.cuda.synchronize()
        self._span.__exit__(None, None, None)
        if i == self.count - 1:
            self.stop()

    def stop(self) -> None:
        """End the profile (at the last traced unit); the trace is written
        by ``export``."""
        if self.prof is not None and not self.done:
            self.prof.stop()
            self.done = True

    def export(self) -> bool:
        """Write the trace; False when no unit was traced."""
        self.stop()
        if self.prof is None:
            return False
        self.prof.export_chrome_trace(self.out_path)
        return True


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def short_name(name: str) -> str:
    """A kernel's name without its argument list or template arguments."""
    n = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    for ch in "(<":
        n = n.split(ch)[0]
    return n.strip()[:80]


def reduce_trace(path: str, kernel_table: Dict[str, List[str]]) -> Optional[Dict]:
    """The numbers of one exported trace: window and busy seconds, device
    time and launches by function of ``kernel_table``, the top device
    operations and the idle gaps by host span. None when the trace holds
    no unit span or no device operation."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    units, spans, dev = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, t0, t1 = e.get("cat", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if cat == "user_annotation":
            (units if e.get("name") == UNIT_SPAN else spans).append((t0, t1, e.get("name", "")))
        elif cat in DEVICE_CATS:
            dev.append((t0, t1, e.get("name", ""), cat))
    if not units or not dev:
        return None
    w0, w1 = min(u[0] for u in units), max(u[1] for u in units)
    dev = [(max(a, w0), min(b, w1), n, c) for a, b, n, c in dev if b > w0 and a < w1]
    busy = _union([(a, b) for a, b, _, _ in dev])
    busy_us = sum(b - a for a, b in busy)
    ops: Dict[str, float] = defaultdict(float)
    by_fn: Dict[str, float] = defaultdict(float)
    launches: Dict[str, int] = defaultdict(int)
    pats = {fn: [re.compile(r"\b%s\b" % re.escape(p)) for p in ps]
            for fn, ps in kernel_table.items() if not fn.startswith("_")}
    for a, b, n, c in dev:
        ops[short_name(n) if c == "kernel" else c] += b - a
        if c != "kernel":
            continue
        for fn, rs in pats.items():
            if any(r.search(n) for r in rs):
                by_fn[fn] += b - a
                launches[fn] += 1
                break
    # idle gaps, named by the innermost host span over their middle
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    spans.sort(key=lambda s: s[1] - s[0])
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = next((n for s0, s1, n in spans if s0 <= mid <= s1), "outside the benchmark's spans")
        gaps[name] += b - a
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_s_by_function": {k: v * 1e-6 for k, v in by_fn.items()},
        "launches_by_function": dict(launches),
        "device_ops": [[k, v * 1e-6] for k, v in top],
        "idle_gaps": [[k, v * 1e-6] for k, v in idle],
    }


def load_kernel_table(bench_dir: str) -> Dict[str, List[str]]:
    with open(os.path.join(bench_dir, "roofline", "kernels.json")) as f:
        return json.load(f)
