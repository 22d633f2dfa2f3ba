"""Experiment folders, metric logging and small utilities.

Replaces the reference's wandb-backed observability (run_train.py:73-75,
286; utils/utils.py:62-81, 218-242) with a JSONL metrics log that
optionally mirrors to wandb when the package is installed.
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, List, Optional


def new_log(folder_path: str, args: Optional[Dict] = None):
    """Create outputs/experiment_<n>_<rand> and dump args.csv
    (reference: utils/utils.py:62-81)."""
    os.makedirs(folder_path, exist_ok=True)
    n_exp = len(os.listdir(folder_path))
    randn = round((time.time() * 1_000_000) % 1000)
    experiment_folder = os.path.join(folder_path, f"experiment_{n_exp}_{randn}")
    os.makedirs(experiment_folder)
    if args is not None:
        write_args(experiment_folder, args)
    return experiment_folder, n_exp, randn


def write_args(folder: str, args: Dict) -> None:
    """The run's configuration as args.csv, one key a row."""
    with open(os.path.join(folder, "args.csv"), "w") as fh:
        w = csv.writer(fh)
        w.writerow(["key", "value"])
        for k, v in args.items():
            w.writerow([k, v])


class MetricsLogger:
    """Append-only JSONL metric stream (+ optional wandb mirror)."""

    def __init__(self, experiment_folder: str, use_wandb: bool = False, project: str = "POPCORN"):
        self.path = os.path.join(experiment_folder, "metrics.jsonl")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, dir=experiment_folder)
                self._wandb = wandb
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict, step: int):
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_histogram(self, name: str, values, step: int, bins: int = 64):
        """Histogram record (the wandb.watch parameter/gradient histograms,
        reference run_train.py:75) -> histograms.jsonl + wandb mirror."""
        import numpy as np

        v = np.asarray(values, np.float32).ravel()
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        counts, edges = np.histogram(v, bins=bins)
        rec = {
            "step": step,
            "name": name,
            "counts": counts.tolist(),
            "edges": [float(edges[0]), float(edges[-1])],
            "mean": float(v.mean()),
            "std": float(v.std()),
        }
        path = os.path.join(os.path.dirname(self.path), "histograms.jsonl")
        with open(path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(
                {name: self._wandb.Histogram(np_histogram=(counts, edges))},
                step=step,
            )


class NumberList:
    """Fixed-window ring buffer for running R² (utils/utils.py:218-242)."""

    def __init__(self, window: int = 400):
        self.numbers: List[float] = []
        self.window = window

    def add(self, nums):
        for num in nums:
            if len(self.numbers) >= self.window:
                self.numbers.pop(0)
            self.numbers.append(float(num))

    def get(self) -> List[float]:
        return self.numbers
