"""Synthetic-region fixture: a complete fake PopMapData tree on disk.

Generalises the reference's ``fake`` debug flag (which substituted random
arrays of the right shapes inside generate_raw_data,
data/PopulationDataset.py:577-587) into a full on-disk fixture: seasonal
S1/S2 mosaics, boundary rasters, census CSVs and (optionally) NaN holes —
so every pipeline stage (IO, dataset, training, sliding-window inference,
census aggregation) can be exercised end-to-end without real satellite
data. Used by the tests and by chip_smoke.py.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import pandas as pd

from ..config import DATALOCATIONS, SEASONS, DataPaths
from ..io.geotiff import write_geotiff


def _smooth_field(rng, h, w, scale=8):
    """Cheap smooth random field via low-res upsampling."""
    low = rng.standard_normal((max(2, h // scale), max(2, w // scale)))
    # bilinear upsample with numpy
    yi = np.linspace(0, low.shape[0] - 1, h)
    xi = np.linspace(0, low.shape[1] - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, low.shape[0] - 1)
    x1 = np.minimum(x0 + 1, low.shape[1] - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    f = (
        low[np.ix_(y0, x0)] * (1 - wy) * (1 - wx)
        + low[np.ix_(y1, x0)] * wy * (1 - wx)
        + low[np.ix_(y0, x1)] * (1 - wy) * wx
        + low[np.ix_(y1, x1)] * wy * wx
    )
    return f


def _make_admin_grid(rng, h, w, ny, nx):
    """Partition the raster into ny*nx rectangular admin regions with
    jittered boundaries; returns (id_raster int32, list of (idx, bbox))."""
    ys = np.unique(
        np.concatenate(
            [[0], np.sort(rng.integers(1, h - 1, ny - 1)) if ny > 1 else [], [h]]
        ).astype(int)
    )
    xs = np.unique(
        np.concatenate(
            [[0], np.sort(rng.integers(1, w - 1, nx - 1)) if nx > 1 else [], [w]]
        ).astype(int)
    )
    ids = np.zeros((h, w), np.int32)
    regions = []
    idx = 1
    for i in range(len(ys) - 1):
        for j in range(len(xs) - 1):
            y0, y1 = int(ys[i]), int(ys[i + 1])
            x0, x1 = int(xs[j]), int(xs[j + 1])
            if y1 <= y0 or x1 <= x0:
                continue
            ids[y0:y1, x0:x1] = idx
            regions.append((idx, (y0, y1, x0, x1)))
            idx += 1
    return ids, regions


def make_synthetic_region(
    root: str,
    region: str = "rwa",
    *,
    height: int = 512,
    width: int = 768,
    n_regions: Tuple[int, int] = (4, 6),
    seed: int = 0,
    nan_fraction: float = 0.0,
    with_fine_level: bool = True,
    pop_scale: float = 500.0,
    with_ascending: bool = False,
    s1_desc_nan_fraction: float = 0.0,
    with_buildings: bool = False,
    with_viirs: bool = False,
) -> DataPaths:
    """Create a synthetic region under ``root`` in the PopMapData layout.

    Population is planted as a smooth 'occupancy' field times a 'building'
    field summed per admin region, so a correct pipeline can actually fit
    it. Returns a DataPaths rooted at ``root``.
    """
    rng = np.random.default_rng(seed)
    paths = DataPaths(root)
    proc = os.path.join(paths.processed, region)
    os.makedirs(proc, exist_ok=True)

    transform = (30.0, 1e-4, -1.5, 1e-4)  # origin_x, px_w, origin_y, px_h

    # -- ground truth fields ---------------------------------------------------
    building = np.clip(_smooth_field(rng, height, width, 16) * 0.5 + 0.2, 0, 1)
    building = np.where(building > 0.45, building, 0.0).astype(np.float32)
    occupancy = np.clip(_smooth_field(rng, height, width, 32) + 1.5, 0.1, 3.0).astype(
        np.float32
    )
    popdense = building * occupancy

    # -- admin levels -----------------------------------------------------------
    levels = list(DATALOCATIONS[region].keys())
    coarse_level = "coarse"
    ids, regions = _make_admin_grid(rng, height, width, *n_regions)

    def write_level(level: str, id_raster, region_list):
        bpath = paths.boundary_path(region, level)
        write_geotiff(
            bpath,
            id_raster.astype(np.float32),
            transform=transform,
            nodata=0.0,
        )
        rows = []
        for idx, (y0, y1, x0, x1) in region_list:
            sel = id_raster[y0:y1, x0:x1] == idx
            pop = float(popdense[y0:y1, x0:x1][sel].sum() * pop_scale / 100.0)
            rows.append(
                {
                    "idx": idx,
                    "POP20": round(pop, 2),
                    "bbox": f"[{y0}, {y1}, {x0}, {x1}]",
                    "count": int(sel.sum()),
                }
            )
        pd.DataFrame(rows).to_csv(paths.census_path(region, level), index=False)

    write_level(coarse_level, ids, regions)

    if with_fine_level:
        # split each coarse cell into quadrants
        fine_ids = np.zeros_like(ids)
        fine_regions = []
        fidx = 1
        for idx, (y0, y1, x0, x1) in regions:
            ym, xm = (y0 + y1) // 2, (x0 + x1) // 2
            for (a0, a1, b0, b1) in [
                (y0, ym, x0, xm),
                (y0, ym, xm, x1),
                (ym, y1, x0, xm),
                (ym, y1, xm, x1),
            ]:
                if a1 <= a0 or b1 <= b0:
                    continue
                fine_ids[a0:a1, b0:b1] = fidx
                fine_regions.append((fidx, (a0, a1, b0, b1)))
                fidx += 1
        for level in levels:
            if level == coarse_level:
                continue
            write_level(level, fine_ids, fine_regions)

    # -- seasonal imagery --------------------------------------------------------
    for season in SEASONS:
        szn = rng.standard_normal((height, width)).astype(np.float32) * 0.05

        # S2: 4 bands uint16 (B02,B03,B04,B08), building areas brighter
        base = _smooth_field(rng, height, width, 8).astype(np.float32)
        s2 = np.stack(
            [
                np.clip((base * 300 + 1400 + building * 800 + szn * 100 + k * 50), 0, 10000)
                for k in range(4)
            ]
        ).astype(np.float32)
        if nan_fraction > 0:
            mask = rng.random((height, width)) < nan_fraction
            s2[:, mask] = 0.0  # uint16 has no NaN; zeros act as gaps
        write_geotiff(
            paths.modality_path(region, "S2", season),
            s2,
            transform=transform,
            dtype=np.uint16,
        )

        # S1: 2 bands float32 (VV,VH in dB), buildings brighter backscatter
        s1 = np.stack(
            [
                (-15 + building * 8 + base * 2 + szn),
                (-21 + building * 6 + base * 2 + szn),
            ]
        ).astype(np.float32)
        if with_ascending:
            # ascending-orbit fill data (the uga workflow): complete coverage
            write_geotiff(
                paths.modality_path(region, "S1", season, asc=True),
                s1,
                transform=transform,
                nodata=float("nan"),
            )
        s1 = s1.copy()
        frac = max(nan_fraction, s1_desc_nan_fraction)
        if frac > 0:
            mask = rng.random((height, width)) < frac
            s1[:, mask] = np.nan
        write_geotiff(
            paths.modality_path(region, "S1", season),
            s1,
            transform=transform,
            nodata=float("nan"),
        )

    if with_buildings:
        # pre-rasterised building counts + segmentation in the Google/Swiss
        # Buildings layout (reference PopulationDataset.py:269-287), derived
        # from the planted building field so the -binp occupancy path can
        # actually fit the population
        counts = (building * 4.0).astype(np.float32)
        seg = (building > 0).astype(np.float32)
        for path, arr in (
            (paths.gbuildings_counts_path(region), counts),
            (paths.gbuildings_segmentation_path(region), seg),
        ):
            write_geotiff(path, arr[None], transform=transform)

    if with_viirs:
        # season-less VIIRS nightlights covariate, correlated with popdense
        viirs = (popdense * 20.0 + _smooth_field(rng, height, width, 32) * 0.5).astype(
            np.float32
        )
        write_geotiff(
            paths.modality_path(region, "viirs", ""), viirs[None], transform=transform
        )

    # ground-truth fields for test assertions
    np.save(os.path.join(proc, "_gt_building.npy"), building)
    np.save(os.path.join(proc, "_gt_popdense.npy"), popdense * pop_scale / 100.0)
    return paths
