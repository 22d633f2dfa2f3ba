"""Virtual mosaics over unmerged raster tiles.

Native equivalent of the reference's on-the-fly GDAL VRT fallback
(data/PopulationDataset.py:176-263): when a merged seasonal mosaic is
missing, windowed reads are served directly from the raw per-tile GeoTIFFs
by intersecting the query window with each tile's georeferenced extent.
The tile index is computed once and cached as JSON next to the tiles.

Also provides ``merge_tiles`` — the native replacement for the reference's
gdal.Warp-based utils/03_merge_tiffs.py — which materialises a mosaic into
a single tiled GeoTIFF.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .geotiff import GeoTIFF, write_geotiff


class MosaicIndex:
    """Georeferenced index over same-resolution, north-up, axis-aligned tiles."""

    def __init__(
        self,
        tiles: List[Dict],
        origin_x: float,
        origin_y: float,
        px_w: float,
        px_h: float,
        width: int,
        height: int,
        count: int,
        nodata: Optional[float],
    ):
        self.tiles = tiles  # [{path, row0, col0, h, w}]
        self.origin_x = origin_x
        self.origin_y = origin_y
        self.px_w = px_w
        self.px_h = px_h  # negative (north-up)
        self.width = width
        self.height = height
        self.count = count
        self.nodata = nodata

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def transform(self) -> Tuple[float, ...]:
        return (self.origin_x, self.px_w, 0.0, self.origin_y, 0.0, self.px_h)

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(cls, tile_paths: Sequence[str]) -> "MosaicIndex":
        if not tile_paths:
            raise ValueError("no tiles")
        metas = []
        for p in tile_paths:
            with GeoTIFF(p) as g:
                if g.transform is None:
                    raise ValueError(f"tile {p} lacks geo transform")
                ox, pw, _, oy, _, ph = g.transform
                metas.append((p, ox, oy, pw, ph, g.width, g.height, g.count, g.nodata))
        _, _, _, pw0, ph0, _, _, count0, nodata0 = metas[0]
        for m in metas:
            if abs(m[3] - pw0) > 1e-12 * abs(pw0) or abs(m[4] - ph0) > 1e-12 * abs(ph0):
                raise ValueError("tiles have differing resolutions")
        min_x = min(m[1] for m in metas)
        max_y = max(m[2] for m in metas)
        max_x = max(m[1] + m[5] * pw0 for m in metas)
        min_y = min(m[2] + m[6] * ph0 for m in metas)
        width = int(round((max_x - min_x) / pw0))
        height = int(round((min_y - max_y) / ph0))
        tiles = []
        for p, ox, oy, pw, ph, w, h, c, nd in metas:
            col0 = int(round((ox - min_x) / pw0))
            row0 = int(round((oy - max_y) / ph0))
            tiles.append({"path": p, "row0": row0, "col0": col0, "h": h, "w": w})
        return cls(tiles, min_x, max_y, pw0, ph0, width, height, count0, nodata0)

    @classmethod
    def from_dir(cls, tile_dir: str, cache: Optional[str] = None) -> "MosaicIndex":
        """Index all .tif files in a directory, with JSON caching
        (the VRT-file equivalent of PopulationDataset.py:192-219)."""
        if cache and os.path.exists(cache):
            return cls.load(cache)
        paths = sorted(
            os.path.join(tile_dir, f)
            for f in os.listdir(tile_dir)
            if f.endswith(".tif")
        )
        idx = cls.build(paths)
        if cache:
            idx.save(cache)
        return idx

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {
                    "tiles": self.tiles,
                    "origin_x": self.origin_x,
                    "origin_y": self.origin_y,
                    "px_w": self.px_w,
                    "px_h": self.px_h,
                    "width": self.width,
                    "height": self.height,
                    "count": self.count,
                    "nodata": self.nodata,
                },
                f,
            )

    @classmethod
    def load(cls, path: str) -> "MosaicIndex":
        with open(path) as f:
            d = json.load(f)
        return cls(**d)

    # -- reads ----------------------------------------------------------------

    def read(
        self,
        bands: Optional[Sequence[int]] = None,
        window: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None,
    ) -> np.ndarray:
        """Windowed read; uncovered pixels become NaN (or the nodata value)."""
        if bands is None:
            bands = list(range(1, self.count + 1))
        elif isinstance(bands, int):
            bands = [bands]
        if window is None:
            window = ((0, self.height), (0, self.width))
        (r0, r1), (c0, c1) = window
        h, w = r1 - r0, c1 - c0
        fill = np.float32(np.nan if self.nodata is None else self.nodata)
        out = np.full((len(bands), h, w), fill, np.float32)
        for t in self.tiles:
            ir0 = max(r0, t["row0"])
            ir1 = min(r1, t["row0"] + t["h"])
            ic0 = max(c0, t["col0"])
            ic1 = min(c1, t["col0"] + t["w"])
            if ir0 >= ir1 or ic0 >= ic1:
                continue
            with GeoTIFF(t["path"]) as g:
                chunk = g.read(
                    bands,
                    window=(
                        (ir0 - t["row0"], ir1 - t["row0"]),
                        (ic0 - t["col0"], ic1 - t["col0"]),
                    ),
                )
            out[:, ir0 - r0 : ir1 - r0, ic0 - c0 : ic1 - c0] = chunk
        return out


def merge_tiles(
    tile_dir: str,
    out_path: str,
    *,
    dtype=None,
    nodata: Optional[float] = None,
    chunk_rows: int = 2048,
) -> str:
    """Materialise a tile directory into one GeoTIFF mosaic.

    Native replacement for the reference's gdal.Warp mosaicking
    (utils/03_merge_tiffs.py:22-117); uint16 output reproduces the
    reference's S2 storage choice (README.md:245).
    """
    idx = MosaicIndex.from_dir(tile_dir)
    data = np.empty((idx.count, idx.height, idx.width), np.float32)
    for r0 in range(0, idx.height, chunk_rows):
        r1 = min(idx.height, r0 + chunk_rows)
        data[:, r0:r1] = idx.read(window=((r0, r1), (0, idx.width)))
    write_geotiff(
        out_path,
        data,
        transform=(idx.origin_x, idx.px_w, idx.origin_y, -idx.px_h),
        nodata=nodata if nodata is not None else idx.nodata,
        dtype=dtype,
    )
    return out_path
