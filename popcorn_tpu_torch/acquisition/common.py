"""Shared acquisition helpers (pure python, unit-tested).

Seasonal windows, job-retry with backoff, tile-grid and bbox splitting —
behaviourally matching the reference download scripts
(utils/01_download_gee_country.py:24-60, utils/download_sentinelhub.py:147-173).

Counterpart of popcorn_tpu/acquisition/common.py, copied with relative imports.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

# Seasonal S2 composite windows (reference: 01_download_gee_country.py:24-30).
def season_windows(year: int) -> Dict[str, Tuple[str, str]]:
    return {
        "spring": (f"{year}-03-01", f"{year}-06-01"),
        "summer": (f"{year}-06-01", f"{year}-09-01"),
        "autumn": (f"{year}-09-01", f"{year}-12-01"),
        "winter": (f"{year}-12-01", f"{year + 1}-03-01"),
    }


# s2cloudless pipeline constants (reference :40-44).
CLOUD_FILTER = 60
CLD_PRB_THRESH = 60
NIR_DRK_THRESH = 0.15
CLD_PRJ_DIST = 2
BUFFER = 60


def retry_submit(
    submit: Callable[[], None],
    *,
    max_trials: int = 31,
    pause_s: float = 15.0,
    sleep=time.sleep,
) -> int:
    """Submit a job, retrying with a fixed backoff on failure (the EE
    too-many-jobs loop, reference :46-60). Returns the number of retries."""
    try:
        submit()
        return 0
    except Exception:
        pass
    for i in range(max_trials):
        sleep(pause_s)
        try:
            submit()
            return i + 1
        except Exception:
            continue
    raise RuntimeError("could not submit job after retries")


BBox = Tuple[float, float, float, float]  # minx, miny, maxx, maxy


def split_bbox(bbox: BBox, resolution: float, max_pixels: int = 2500) -> List[BBox]:
    """Recursively quarter a bbox until each tile is <= max_pixels on both
    axes at the given resolution (degrees or meters per pixel) — the
    Sentinel-Hub tiling rule (reference download_sentinelhub.py:147-173)."""
    minx, miny, maxx, maxy = bbox
    nx = (maxx - minx) / resolution
    ny = (maxy - miny) / resolution
    if nx <= max_pixels and ny <= max_pixels:
        return [bbox]
    mx = (minx + maxx) / 2.0
    my = (miny + maxy) / 2.0
    out: List[BBox] = []
    for b in (
        (minx, miny, mx, my),
        (mx, miny, maxx, my),
        (minx, my, mx, maxy),
        (mx, my, maxx, maxy),
    ):
        out.extend(split_bbox(b, resolution, max_pixels))
    return out


def tile_grid(bbox: BBox, tile_deg: float) -> List[BBox]:
    """Regular tile grid over a bbox (EE country exports are tiled by EE
    itself; this grid drives URL-mode direct downloads)."""
    minx, miny, maxx, maxy = bbox
    tiles = []
    y = miny
    while y < maxy:
        x = minx
        y1 = min(y + tile_deg, maxy)
        while x < maxx:
            x1 = min(x + tile_deg, maxx)
            tiles.append((x, y, x1, y1))
            x = x1
        y = y1
    return tiles
