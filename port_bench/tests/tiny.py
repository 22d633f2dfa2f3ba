"""Tiny versions of the benchmark's cells for its CPU tests: the cells of
BENCHMARK.json and held/ with a small region, small patches and few members, run
on the program's plain CPU path."""

from __future__ import annotations

import copy
import os

from port_bench.harness import spec

TINY_REGION = {"height": 200, "width": 232, "n_regions": [3, 3], "data_seed": 5}


def tiny_cell(name: str, **model):
    cell = spec.load_cell(name, bench=spec.with_held())
    cell.traffic = dict(copy.deepcopy(cell.traffic), region=dict(TINY_REGION), warm_epochs=1)
    cfg = copy.deepcopy(cell.config)
    cfg["model"].update(model)
    if cell.driver == "eval_map":
        cfg.update(patchsize=96, overlap=16, members=2)
    cell.config = cfg
    return cell


def tiny_run(name: str, cache_dir: str, seed: int = 2 ** 31 + 7, **model):
    """A Run of the tiny cell on the CPU, its region under ``cache_dir``."""
    import port_bench.run as R

    run = R.Run(tiny_cell(name, **model), seed, "cpu")
    run.scratch = os.path.join(cache_dir, "scratch")
    R.prepare_data(run, cache_dir)
    return run
