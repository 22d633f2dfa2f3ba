"""What several per-layer readers share: the device's idle share of a
traced window and the kernels' share of their roofline over it."""

from __future__ import annotations

from typing import Dict, List, Optional

from port_bench.roofline.bounds import bounds_by_function


def idle_pct(record: Dict, driver: str) -> Optional[float]:
    tr = record.get("trace")
    if record.get("driver") != driver or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def roofline_pct(record: Dict, launches: List) -> Optional[float]:
    """Sum of the launches' bounds over the device time of the kernels
    that computed them, for the functions the trace shows at all. None
    where the trace shows none of the functions."""
    tr = record.get("trace")
    if not tr:
        return None
    bounds = bounds_by_function(launches, record["device_name"])
    seen = {f: t for f, t in tr["device_s_by_function"].items() if t > 0 and f in bounds}
    if not seen:
        return None
    return 100.0 * sum(bounds[f] for f in seen) / sum(seen.values())
