"""The benchmark's region generator: a synthetic country in the PopMapData
layout, drawn from a fixed ``data_seed``.

A copy of the program's synthetic-region fixture (the generator its own
tests use), kept here so that later changes to the program cannot move
the yardstick: the same fields, admin grid and per-season imagery in the
same order of draws, written with this folder's own GeoTIFF writer
(traffic/tiff.py). Population is a smooth occupancy field times a
building field, summed per admin region into the census tables; the
seasonal S2 (uint16, B02/B03/B04/B08) and S1 (float32 dB, VV/VH)
mosaics brighten where buildings are.

The layout is the one the reference repository's README gives for a
country ('rwa': census levels 'fine100' and 'coarse'):

  <root>/PopMapData/processed/rwa/boundaries_{coarse,kigali100}.tif, census_*.csv
  <root>/PopMapData/merged/EE/rwa/S2A<season>/rwa_S2A<season>.tif
  <root>/PopMapData/merged/EE/rwa/S1<season>/rwa_S1<season>.tif
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from .tiff import read_tiff, write_tiff

SEASONS = ("spring", "summer", "autumn", "winter")
REGION = "rwa"
LEVELS = {"fine100": ("boundaries_kigali100.tif", "census_kigali100.csv"),
          "coarse": ("boundaries_coarse.tif", "census_coarse.csv")}
TRANSFORM = (30.0, 1e-4, -1.5, 1e-4)


def processed_dir(root: str) -> str:
    return os.path.join(root, "PopMapData", "processed", REGION)


def boundary_path(root: str, level: str) -> str:
    return os.path.join(processed_dir(root), LEVELS[level][0])


def census_path(root: str, level: str) -> str:
    return os.path.join(processed_dir(root), LEVELS[level][1])


def mosaic_path(root: str, modality: str, season: str) -> str:
    name = {"S1": "S1", "S2": "S2A"}[modality] + season
    return os.path.join(root, "PopMapData", "merged", "EE", REGION, name, f"{REGION}_{name}.tif")


def _smooth_field(rng, h, w, scale=8):
    """Smooth random field: a low-resolution normal draw, bilinearly upsampled."""
    low = rng.standard_normal((max(2, h // scale), max(2, w // scale)))
    yi = np.linspace(0, low.shape[0] - 1, h)
    xi = np.linspace(0, low.shape[1] - 1, w)
    y0 = np.floor(yi).astype(int)
    x0 = np.floor(xi).astype(int)
    y1 = np.minimum(y0 + 1, low.shape[0] - 1)
    x1 = np.minimum(x0 + 1, low.shape[1] - 1)
    wy = (yi - y0)[:, None]
    wx = (xi - x0)[None, :]
    return (low[np.ix_(y0, x0)] * (1 - wy) * (1 - wx) + low[np.ix_(y1, x0)] * wy * (1 - wx)
            + low[np.ix_(y0, x1)] * (1 - wy) * wx + low[np.ix_(y1, x1)] * wy * wx)


def _admin_grid(rng, h, w, ny, nx) -> Tuple[np.ndarray, List]:
    """ny x nx rectangles cut at uniformly drawn rows and columns: an id
    raster (0 nowhere, ids from 1) and [(id, (y0, y1, x0, x1))]."""
    ys = np.unique(np.concatenate(
        [[0], np.sort(rng.integers(1, h - 1, ny - 1)) if ny > 1 else [], [h]]).astype(int))
    xs = np.unique(np.concatenate(
        [[0], np.sort(rng.integers(1, w - 1, nx - 1)) if nx > 1 else [], [w]]).astype(int))
    ids = np.zeros((h, w), np.int32)
    regions = []
    idx = 1
    for i in range(len(ys) - 1):
        for j in range(len(xs) - 1):
            y0, y1, x0, x1 = int(ys[i]), int(ys[i + 1]), int(xs[j]), int(xs[j + 1])
            if y1 <= y0 or x1 <= x0:
                continue
            ids[y0:y1, x0:x1] = idx
            regions.append((idx, (y0, y1, x0, x1)))
            idx += 1
    return ids, regions


def _quadrants(regions):
    fine = []
    fidx = 1
    for _, (y0, y1, x0, x1) in regions:
        ym, xm = (y0 + y1) // 2, (x0 + x1) // 2
        for a0, a1, b0, b1 in ((y0, ym, x0, xm), (y0, ym, xm, x1), (ym, y1, x0, xm),
                               (ym, y1, xm, x1)):
            if a1 > a0 and b1 > b0:
                fine.append((fidx, (a0, a1, b0, b1)))
                fidx += 1
    return fine


def make_region(root: str, *, height: int, width: int, n_regions: Tuple[int, int],
                data_seed: int, pop_scale: float = 500.0) -> None:
    """Write the region under ``root``: two census levels (coarse
    rectangles and their quadrants) and four seasons of S2 and S1."""
    rng = np.random.default_rng(data_seed)
    os.makedirs(processed_dir(root), exist_ok=True)
    building = np.clip(_smooth_field(rng, height, width, 16) * 0.5 + 0.2, 0, 1)
    building = np.where(building > 0.45, building, 0.0).astype(np.float32)
    occupancy = np.clip(_smooth_field(rng, height, width, 32) + 1.5, 0.1, 3.0).astype(np.float32)
    popdense = building * occupancy
    ids, regions = _admin_grid(rng, height, width, *n_regions)
    fine_ids = np.zeros_like(ids)
    fine = _quadrants(regions)
    for idx, (a0, a1, b0, b1) in fine:
        fine_ids[a0:a1, b0:b1] = idx
    for level, raster, rects in (("coarse", ids, regions), ("fine100", fine_ids, fine)):
        write_tiff(boundary_path(root, level), raster.astype(np.float32), transform=TRANSFORM,
                   nodata=0.0)
        rows = []
        for idx, (y0, y1, x0, x1) in rects:
            sel = raster[y0:y1, x0:x1] == idx
            pop = float(popdense[y0:y1, x0:x1][sel].sum() * pop_scale / 100.0)
            rows.append({"idx": idx, "POP20": round(pop, 2), "bbox": f"[{y0}, {y1}, {x0}, {x1}]",
                         "count": int(sel.sum())})
        pd.DataFrame(rows).to_csv(census_path(root, level), index=False)
    for season in SEASONS:
        szn = rng.standard_normal((height, width)).astype(np.float32) * 0.05
        base = _smooth_field(rng, height, width, 8).astype(np.float32)
        s2 = np.stack([np.clip(base * 300 + 1400 + building * 800 + szn * 100 + k * 50, 0, 10000)
                       for k in range(4)])
        p = mosaic_path(root, "S2", season)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_tiff(p, np.rint(s2).astype(np.uint16), transform=TRANSFORM)
        del s2
        s1 = np.stack([-15 + building * 8 + base * 2 + szn,
                       -21 + building * 6 + base * 2 + szn]).astype(np.float32)
        p = mosaic_path(root, "S1", season)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        write_tiff(p, s1, transform=TRANSFORM, nodata=float("nan"))


def region_key(spec: Dict) -> str:
    """A directory name that changes with every parameter of the region."""
    blob = json.dumps({k: spec[k] for k in ("height", "width", "n_regions", "data_seed")},
                      sort_keys=True)
    return f"{REGION}_{spec['height']}x{spec['width']}_" + hashlib.sha1(blob.encode()).hexdigest()[:10]


def ensure_region(cache_dir: str, spec: Dict) -> str:
    """The data root of the region ``spec`` under ``cache_dir``, made on
    first use (written beside and renamed into place, so a run cut off
    while writing leaves nothing that looks finished)."""
    root = os.path.join(cache_dir, region_key(spec))
    if os.path.isdir(root):
        return root
    tmp = root + ".partial"
    shutil.rmtree(tmp, ignore_errors=True)
    make_region(tmp, height=spec["height"], width=spec["width"],
                n_regions=tuple(spec["n_regions"]), data_seed=spec["data_seed"])
    os.replace(tmp, root)
    return root


def read_season(root: str, season: str) -> Tuple[np.ndarray, np.ndarray]:
    """(S2 (4, H, W) uint16 in B02, B03, B04, B08 order, S1 (2, H, W)
    float32 VV, VH) of one season, as written."""
    return read_tiff(mosaic_path(root, "S2", season)), read_tiff(mosaic_path(root, "S1", season))


def read_level(root: str, level: str) -> Tuple[np.ndarray, pd.DataFrame]:
    """(id raster (H, W) float32, census table) of one census level."""
    return read_tiff(boundary_path(root, level))[0], pd.read_csv(census_path(root, level))


def crop_sizes(root: str, level: str, halo: int = 32) -> Dict[int, Tuple[int, int]]:
    """{census id: (rows, columns)} of each census region's training crop:
    its bounding box with ``halo`` pixels around it, clamped to the raster."""
    table = pd.read_csv(census_path(root, level))
    ids, _ = read_level(root, level)
    h, w = ids.shape
    out = {}
    for idx, bbox in zip(table["idx"], table["bbox"]):
        xmin, xmax, ymin, ymax = (int(v) for v in str(bbox).strip("[]()").split(","))
        out[int(idx)] = (min(xmax + halo, h) - max(xmin - halo, 0),
                         min(ymax + halo, w) - max(ymin - halo, 0))
    return out
