"""Driver of the Bag-of-POPCORN map: ``Evaluator.test_target(save=False)``
of the program, back to back, over one region.

Set-up draws the members from the seed, builds the Evaluator and makes
one map (every shape and first call of the cell). The window makes maps
until ``seconds`` have passed, the map in flight finished and counted
(a traced run then profiles a few more maps);
each map's ``timings`` split comes from the program
(run_sliding_inference's host-clock spans), its wall from the host clock
around the call. Two call sites of the program's Evaluator module are
wrapped from here, with no edit to the program: the sliding window and
the device census, to name the host's spans in the trace and to keep the
outputs of one map drawn from the seed (reservoir sampling) for the
comparison with the plain reference after the window.
"""

from __future__ import annotations

import gc
import random
import time
from typing import Dict, List

import numpy as np
import pandas as pd
import torch

from port_bench.harness import compare
from port_bench.harness.weights import make_members
from port_bench.reference.evaluate import evaluate, patch_grid
from port_bench.reference.model import dda_input, load_stats
from port_bench.traffic.region import REGION, SEASONS, census_path, read_season


class _Capture:
    """The outputs of the map in flight: its stitched maps and the
    census sums of each DeviceCensus call, in call order."""

    def __init__(self):
        self.maps = None
        self.calls: List = []

    def take(self) -> Dict:
        out = {"maps": self.maps, "calls": self.calls}
        self.maps, self.calls = None, []
        return out


def _install(capture: _Capture):
    """Wrap the Evaluator module's run_sliding_inference and DeviceCensus
    (the originals, where an earlier run in this process wrapped them)."""
    import popcorn_tpu_torch.infer.evaluator as ev_mod

    sliding = getattr(ev_mod.run_sliding_inference, "__wrapped__", ev_mod.run_sliding_inference)
    census_cls = getattr(ev_mod.DeviceCensus, "wrapped_class", ev_mod.DeviceCensus)

    def run_sliding_inference(*a, **kw):
        with torch.autograd.profiler.record_function("eval.sliding_window"):
            capture.maps = sliding(*a, **kw)
        return capture.maps

    class DeviceCensus(census_cls):
        def __init__(self, *a, **kw):
            with torch.autograd.profiler.record_function("eval.census"):
                super().__init__(*a, **kw)

        def sums(self, pred):
            with torch.autograd.profiler.record_function("eval.census"):
                s = super().sums(pred)
            capture.calls.append(("sums", self.k, pred, s))
            return s

        def adjust(self, pred):
            with torch.autograd.profiler.record_function("eval.census"):
                adj = super().adjust(pred)
            capture.calls.append(("adjust", self.k, adj, None))
            return adj

    run_sliding_inference.__wrapped__ = sliding
    DeviceCensus.wrapped_class = census_cls
    ev_mod.run_sliding_inference = run_sliding_inference
    ev_mod.DeviceCensus = DeviceCensus


def fit_input(run, px: int) -> torch.Tensor:
    """The network input of the region's top-left ``px`` x ``px`` crop in
    its first season: the crop the members' heads are fitted on."""
    s2, s1 = read_season(run.data_root, SEASONS[0])
    s2 = torch.from_numpy(s2[[2, 1, 0, 3], :px, :px].astype(np.float32))[None].to(run.device)
    s1 = torch.from_numpy(np.ascontiguousarray(s1[:, :px, :px]))[None].to(run.device)
    return dda_input(s2, s1, load_stats(run.device))


def setup(run) -> None:
    from popcorn_tpu_torch.config import DataPaths, EvalConfig, ModelConfig
    from popcorn_tpu_torch.infer.evaluator import Evaluator

    cfg, tr = run.cell.config, run.cell.traffic
    head = cfg["member_head"]
    run.members = make_members(run.dda_path, run.tmp("members"), run.seed, cfg["members"],
                               perturb=cfg["member_perturb"], biasinit=cfg["model"]["biasinit"],
                               device=run.device, fit=fit_input(run, head["fit_px"]),
                               spread=head["spread"])
    mcfg = ModelConfig(**cfg["model"])
    ecfg = EvalConfig(target_regions=(REGION,), train_level=(cfg["train_level"],),
                      checkpoints=tuple(run.members), fourseasons=cfg["fourseasons"],
                      patchsize=cfg["patchsize"], overlap=cfg["overlap"],
                      device_feed=cfg["device_feed"], num_workers=tr["num_workers"])
    run.capture = _Capture()
    _install(run.capture)
    run.evaluator = Evaluator(DataPaths(run.data_root), mcfg, ecfg, device=run.device)
    run.evaluator.test_target(save=False)  # the first map: first calls, every shape
    run.capture.take()
    run.sync()


def window(run, seconds: float, tracer=None) -> Dict:
    """Maps back to back for ``seconds``; then, with a ``tracer``, its
    maps under the profiler, outside the window and its numbers."""
    cfg = run.cell.config
    rng = random.Random(run.seed)
    maps, kept = [], None
    t0 = time.perf_counter()
    i = 0
    while True:
        timings: Dict = {}
        ts = time.perf_counter()
        with torch.autograd.profiler.record_function("eval.test_target"):
            run.evaluator.test_target(save=False, timings=timings)
        te = time.perf_counter()
        rec = run.capture.take()
        maps.append({"wall_s": te - ts, "timings": timings.get(REGION, {})})
        if rng.random() * (i + 1) < 1.0:  # reservoir of one: each map equally likely
            kept = rec
        i += 1
        if te - t0 >= seconds:
            break
    run.sync()
    window_s = time.perf_counter() - t0
    traced = []
    for j in range(tracer.count if tracer is not None else 0):
        timings = {}
        tracer.unit_begin(j)
        with torch.autograd.profiler.record_function("eval.test_target"):
            run.evaluator.test_target(save=False, timings=timings)
        tracer.unit_end(j)
        run.capture.take()
        traced.append({"timings": timings.get(REGION, {})})
    h, w = run.evaluator.datasets[0].shape()
    visits = len(patch_grid(h, w, cfg["patchsize"], cfg["overlap"], cfg["fourseasons"]))
    n_patches = sum(int(m["timings"].get("n_patches", 0)) for m in maps)
    run.kept = kept
    run.missing_visits = visits * len(maps) - n_patches
    run.notes["maps_wall_window_s"] = [[round(m["wall_s"], 3), round(m["timings"].get("total_s", 0), 3)]
                                       for m in maps]
    return {
        "units": maps, "traced": traced, "window_s": window_s, "attempted": len(maps), "failed": 0,
        "n_patches": n_patches, "visits_per_map": visits,
        "end_to_end": {"eval_patches_per_s": n_patches / window_s},
    }


def _program_outputs(kept: Dict, levels_by_k: Dict[int, str]) -> Dict:
    """The kept map's outputs on the host: its maps and census sums."""
    out = {k: kept["maps"][k].double().cpu() for k in ("map", "map_std", "scale", "scale_std")}
    adj = None
    for kind, k, t, s in kept["calls"]:
        if kind == "adjust":
            adj = t
            out["adj"] = t.double().cpu()
            continue
        lv = levels_by_k[k]
        tag = "census" if t is kept["maps"]["map"] else ("adj_census" if t is adj else None)
        if tag is not None:
            out[f"{tag}.{lv}"] = np.asarray(s, np.float64)
    return out


def release(run) -> None:
    """Free the program's device state; keep the sampled map on the host."""
    levels_by_k = {len(pd.read_csv(census_path(run.data_root, lv))): lv
                   for lv in run.cell.config["levels"]}
    run.program_out = _program_outputs(run.kept, levels_by_k)
    run.kept = None
    run.evaluator = None
    gc.collect()
    torch.cuda.empty_cache()


def check(run) -> Dict[str, float]:
    cfg = run.cell.config
    ref = evaluate(run.data_root, run.members, patch=cfg["patchsize"], overlap=cfg["overlap"],
                   fourseasons=cfg["fourseasons"], levels=cfg["levels"],
                   train_level=cfg["train_level"], device=run.device)
    return compare.eval_numbers(run.program_out, ref, cfg["levels"], run.missing_visits)
