"""Finding a cell's files by name: ``BENCHMARK.json`` at the checkout's
root names the cells and metrics; ``workloads/<cell>.json`` names the
cell's configuration, traffic mix and driver; ``configs/<config>.json``,
``traffic/mixes/<traffic>.json``, ``drivers/<driver>.py`` and
``metrics/<metric>.py`` hold the rest. Adding a cell, a configuration or
a per-layer metric adds files and entries; nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import the Python file at ``path`` under the module name ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]

    @property
    def driver(self) -> str:
        return self.workload["driver"]


def applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def benchmark(root: str = ROOT) -> Dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def with_held(root: str = ROOT) -> Dict:
    """BENCHMARK.json with the cells held out of it: ``held/<cell>.json``
    holds the entries a cell brings (configs, workloads, end_to_end,
    per_layer) while its runs on the card spread too widely for a bound;
    its tests and calibration read it from there. An entry that
    BENCHMARK.json already has is taken from BENCHMARK.json."""
    bench = benchmark(root)
    hdir = os.path.join(root, os.path.basename(BENCH_DIR), "held")
    for fname in sorted(os.listdir(hdir)) if os.path.isdir(hdir) else []:
        held = _json(os.path.join(hdir, fname))
        for group, entries in held.items():
            have = {e["name"] for e in bench[group]}
            bench[group] = bench[group] + [e for e in entries if e["name"] not in have]
    return bench


def load_cell(name: str, root: str = ROOT, bench: Optional[Dict] = None) -> Cell:
    """The cell ``name`` of BENCHMARK.json with its workload, configuration
    and traffic files, and the metrics it reports."""
    bench = bench if bench is not None else benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    bdir = os.path.join(root, os.path.basename(BENCH_DIR))
    workload = _json(os.path.join(bdir, "workloads", f"{name}.json"))
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(os.path.join(root, cfg_entry["file"]))
    traffic = _json(os.path.join(bdir, "traffic", "mixes", f"{entry['traffic']}.json"))
    return Cell(name, entry["config"], int(entry["chips"]), workload, config, traffic,
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """The ``read(record)`` function of metrics/<name>.py."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    return load_module(path, "port_bench_metric_" + re.sub(r"\W", "_", name)).read


def driver_module(name: str, bench_dir: str = BENCH_DIR):
    return load_module(os.path.join(bench_dir, "drivers", f"{name}.py"), f"port_bench_driver_{name}")


def limits(config_name: str, bench_dir: str = BENCH_DIR) -> Dict[str, float]:
    """{number: limit} of the comparison that decides ``correct`` for a
    configuration's cells (limits/<config>.json)."""
    return {k: float(v["limit"]) for k, v in
            _json(os.path.join(bench_dir, "limits", f"{config_name}.json")).items()
            if not k.startswith("_")}
