"""Ensemble population time series over dated or seasonal frame sets.

Counterpart of popcorn_tpu/infer/pop_timeseries.py (the intent of the
reference's time_series_inference.ipynb, which is bit-rotted): for each
time step run the Bag-of-POPCORN ensemble over that step's S1/S2 mosaics
(infer/sliding.py::run_sliding_inference, on ``device``), write the mean
and std population maps, and tabulate the regional totals in
``totals.csv`` (label, total_population, total_std), written with the
standard csv module in pandas' ``to_csv`` float format (``repr`` of a
float). A time step is a PopMapData-layout region directory per date, so
yearly mosaics can live side by side. The JAX package also draws
``totals.png`` when matplotlib imports; the port leaves the plot out (it
imports no plotting library) and writes the table the plot is drawn from.
With ``mesh=`` each step's eval splits over the ranks
(run_sliding_inference(mesh=)); rank 0 writes the maps and the table.
``spatial=True`` runs each step whole-frame (infer/spatial.py) instead of
the stitched eval.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Sequence, Tuple

from ..config import DataPaths, ModelConfig
from ..data.dataset import PopulationDataset
from ..data.normalize import NormStats
from ..dist.mesh import resolve_device
from .sliding import run_sliding_inference

TOTALS_COLUMNS = ("label", "total_population", "total_std")


def run_population_timeseries(
    members: Sequence,
    consts,
    mcfg: ModelConfig,
    steps: Sequence[Tuple[str, DataPaths, str]],
    output_dir: str,
    *,
    patchsize: int = 2048,
    overlap: int = 128,
    fourseasons: bool = True,
    patch_batch: int = 1,
    mesh=None,
    device="cuda",
    spatial: bool = False,
    transport: str = "exact",
) -> List[Dict]:
    """steps: [(label, paths, region), ...] ordered in time.

    Writes <region>_predictions_<label>.tif (and _STD) per step and
    totals.csv; returns the totals records (rank 0; [] on the other ranks
    of a ``mesh``)."""
    dev = resolve_device(mesh.device if mesh is not None else device)
    root = mesh is None or mesh.is_root
    if root:
        os.makedirs(output_dir, exist_ok=True)
    stats = NormStats(device=dev)
    records = []
    for label, paths, region in steps:
        ds = PopulationDataset(
            paths, region, mode="test", patchsize=patchsize, overlap=overlap,
            s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir, fourseasons=fourseasons,
        )
        try:
            if spatial:
                from .spatial import run_spatial_inference

                maps = run_spatial_inference(members, consts, mcfg, ds, stats=stats,
                                             transport=transport, mesh=mesh, device=dev)
            else:
                maps = run_sliding_inference(members, consts, mcfg, ds, stats=stats,
                                             batch_size=patch_batch, device=dev, mesh=mesh,
                                             transport=transport)
            if maps is not None:
                ds.save(maps["map"], output_dir, tag=f"_{label}")
                ds.save(maps["map_std"], output_dir, tag=f"_{label}_STD")
        finally:
            ds.close()
        if maps is None:  # a rank other than 0
            continue
        records.append({
            "label": label,
            "total_population": float(maps["map"].sum()),
            "total_std": float(maps["map_std"].sum()),
        })
    if not root:
        return records
    with open(os.path.join(output_dir, "totals.csv"), "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(TOTALS_COLUMNS)
        for r in records:
            w.writerow([r["label"], repr(r["total_population"]), repr(r["total_std"])])
    return records
