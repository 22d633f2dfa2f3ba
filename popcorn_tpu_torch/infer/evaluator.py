"""Bag-of-POPCORN ensemble evaluation.

Counterpart of popcorn_tpu/infer/evaluator.py (reference
run_eval.py:29-269): loads N ``.pth`` members, runs the sliding-window
ensemble per region, writes the mean/STD/SCALE/SCALE_STD GeoTIFFs,
evaluates census metrics per level, then applies the dasymmetric
adjustment, writes the ADJ map and re-evaluates. Maps stitched on the
device stay there for the census (``DeviceCensus``); maps stitched on the
host (a region above the device-stitch budget) take the host route
(``convert_popmap_to_census``, ``adjust_map_to_census``), as the JAX
package's Evaluator does.

Under ranks (``mesh``, dist/mesh.py) every rank loads the members and
runs its share of the eval; rank 0 alone holds the maps, writes the
products and computes the census metrics. ``EvalConfig.spatial`` runs
the whole-frame path (infer/spatial.py) over the mesh, or on this
process's device, as the JAX package's Evaluator does.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from ..agg.census_agg import (
    DeviceCensus,
    adjust_map_to_census,
    convert_popmap_to_census,
    detail_maps,
)
from ..compat.weights import load_popcorn_checkpoint
from ..config import NEED_ASCENDING_FILL, TESTLEVELS_EVAL, DataPaths, EvalConfig, ModelConfig
from ..data.dataset import PopulationDataset
from ..data.normalize import NormStats
from ..io.geotiff import GeoTIFF
from ..losses.metrics import get_test_metrics
from ..utils.log import MetricsLogger, write_args
from ..dist.mesh import resolve_device
from .sliding import run_sliding_inference
from .spatial import run_spatial_inference


def load_member(path: str):
    """Load one ensemble member, a ``.pth``/``.pt`` checkpoint in the
    reference format, as (params, consts)."""
    if not os.path.exists(path):
        raise FileNotFoundError(f"No checkpoint found at '{path}'")
    if path.endswith(".pth") or path.endswith(".pt"):
        return load_popcorn_checkpoint(path)
    raise ValueError(
        f"'{path}' is not a .pth/.pt checkpoint. Orbax checkpoint directories "
        "are the JAX package's format: export them to .pth with "
        "tools/export_torch_checkpoint.py first."
    )


class _MapWriter:
    """One background writer: fetches a (possibly device-resident) map and
    writes its GeoTIFF while the caller goes on with census aggregation."""

    def __init__(self, dataset):
        self._ds = dataset
        self._items: list = []
        self._thread: threading.Thread = None

    def put(self, arr, folder: str, tag: str = ""):
        self._items.append((arr, folder, tag))
        if self._thread is None or not self._thread.is_alive():
            self._drain()

    def _drain(self):
        items, self._items = self._items, []

        def work():
            for arr, folder, tag in items:
                if isinstance(arr, torch.Tensor):
                    arr = arr.cpu().numpy()
                self._ds.save(np.asarray(arr), folder, tag=tag)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def join(self):
        while self._items or (self._thread is not None and self._thread.is_alive()):
            if self._thread is not None:
                self._thread.join()
            if self._items:
                self._drain()


class Evaluator:
    def __init__(
        self,
        paths: DataPaths,
        mcfg: ModelConfig,
        ecfg: EvalConfig,
        *,
        consts=None,
        device="cuda",
        use_wandb: bool = False,
        mesh=None,
    ):
        if not ecfg.checkpoints:
            raise ValueError("EvalConfig.checkpoints is empty")
        self.paths = paths
        self.mcfg = mcfg
        self.ecfg = ecfg
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None else device)
        self.is_root = mesh is None or mesh.is_root

        first_dir = os.path.dirname(os.path.abspath(ecfg.checkpoints[0]))
        self.experiment_folder = os.path.join(
            first_dir,
            "eval_outputs_ensemble_{}_members_{}".format(
                time.strftime("%Y%m%d-%H%M%S"), len(ecfg.checkpoints)
            ),
        )
        if mesh is not None:
            self.experiment_folder = mesh.broadcast_object(self.experiment_folder)
        self.logger = None
        if self.is_root:
            os.makedirs(self.experiment_folder, exist_ok=True)
            # the model config carries ``quantize`` into the fold and the record
            write_args(self.experiment_folder,
                       {**dataclasses.asdict(mcfg), **dataclasses.asdict(ecfg)})
            self.logger = MetricsLogger(self.experiment_folder, use_wandb=use_wandb)

        self.members = []
        self.consts = consts
        for p in ecfg.checkpoints:
            params, member_consts = load_member(p)
            self.members.append(params)
            if self.consts is None:
                self.consts = member_consts

        self.datasets = [
            PopulationDataset(
                paths, reg, mode="test",
                patchsize=ecfg.patchsize, overlap=ecfg.overlap,
                s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir, viirs=mcfg.viirs,
                fourseasons=ecfg.fourseasons,
                ascfill=reg in NEED_ASCENDING_FILL,
                train_level=lvl,
                in_memory=ecfg.in_memory,
                sentinelbuildings=mcfg.sentinel_buildings,
            )
            for reg, lvl in zip(ecfg.target_regions, ecfg.train_level)
        ]
        self.stats = NormStats(device=self.device)

    def test_target(
        self, save: bool = True, full: bool = False, timings: Optional[Dict[str, Dict]] = None
    ) -> Dict[str, float]:
        """Census metrics of every target region (rank 0; the other ranks
        return {}). ``timings``: a dict that receives each region's
        sliding-window split (infer/sliding.py::run_sliding_inference's
        ``timings``; the whole-frame split with ``spatial``)."""
        out: Dict[str, float] = {}
        for ds in self.datasets:
            if self.ecfg.spatial:
                # whole-region path: exact model output, no stitch; the
                # maps stay on the device for the census, as a device stitch's
                maps = run_spatial_inference(
                    self.members, self.consts, self.mcfg, ds, stats=self.stats, mesh=self.mesh,
                    device=self.device, progress=True, transport=self.ecfg.transport,
                    timings=None if timings is None else timings.setdefault(ds.region, {}),
                    return_device=True,
                )
            else:
                # maps stitched on the device stay there: census aggregation
                # and the dasymmetric adjustment run there, and only the maps
                # that are written to GeoTIFF come to the host
                maps = run_sliding_inference(
                    self.members, self.consts, self.mcfg, ds,
                    stats=self.stats, batch_size=self.ecfg.patch_batch,
                    progress=True, num_workers=self.ecfg.num_workers,
                    device=self.device, device_feed=self.ecfg.device_feed,
                    transport=self.ecfg.transport, return_device=True,
                    timings=None if timings is None else timings.setdefault(ds.region, {}),
                    debug_nans=self.ecfg.debug_nans, mesh=self.mesh,
                )
            if maps is None:  # a rank other than 0
                continue
            is_dev = isinstance(maps["map"], torch.Tensor)
            writer = _MapWriter(ds) if save else None
            if save:
                writer.put(maps["map"], self.experiment_folder)
                writer.put(maps["map_std"], self.experiment_folder, tag="STD")
                if self.mcfg.occupancy_model:
                    writer.put(maps["scale"], self.experiment_folder, tag=f"SCALE_{ds.region}")
                    writer.put(maps["scale_std"], self.experiment_folder, tag="SCALE_STD")

            boundaries: Dict[str, np.ndarray] = {}
            dcs: Dict[str, DeviceCensus] = {}
            censuses: Dict[str, pd.DataFrame] = {}

            def _level_census(level):
                if level not in boundaries:
                    with GeoTIFF(ds.boundary_paths[level]) as g:
                        boundaries[level] = g.read(1, squeeze=True)
                    censuses[level] = pd.read_csv(ds.census_paths[level])
                    if is_dev:
                        dcs[level] = DeviceCensus(boundaries[level], censuses[level], self.device)

            def _convert(pred, level):
                _level_census(level)
                if is_dev:
                    return dcs[level].convert(pred)
                return convert_popmap_to_census(pred, boundaries[level], censuses[level])

            levels = TESTLEVELS_EVAL.get(ds.region, ["coarse"])
            for level in levels:
                pred_c, gt_c = _convert(maps["map"], level)
                out.update(get_test_metrics(pred_c, gt_c, tag=f"MainCensus_{ds.region}_{level}"))
                if full:
                    host_map = maps["map"].cpu().numpy() if is_dev else maps["map"]
                    det = detail_maps(host_map, boundaries[level], censuses[level])
                    ddir = os.path.join(self.experiment_folder, f"{ds.region}_{level}")
                    for name, m in det.items():
                        ds.save(m, ddir, tag=f"_{name}")

            # dasymmetric adjustment at the train level (run_eval.py:181-200)
            lvl = ds.train_level
            _level_census(lvl)
            if is_dev:
                adj = dcs[lvl].adjust(maps["map"])
            else:
                adj = adjust_map_to_census(maps["map"], boundaries[lvl], censuses[lvl])
            if save:
                writer.put(adj, self.experiment_folder, tag=f"ADJ_{ds.region}")
            for level in levels:
                pred_c, gt_c = _convert(adj, level)
                out.update(get_test_metrics(pred_c, gt_c, tag=f"AdjCensus_{ds.region}_{level}"))
            if writer is not None:
                writer.join()
        if self.logger is not None:
            self.logger.log({f"{k}/targettest": v for k, v in out.items()}, 0)
        return out
