"""Population dataset: weakly-supervised census crops and sliding-window
test patches over country-scale seasonal mosaics.

Re-implements the behaviour of the reference's Population_Dataset
(data/PopulationDataset.py:30-672) on top of the native GeoTIFF IO:

  * weaksup mode: one census region per item — variable-size bbox crop
    with a 32 px admin halo, random season (and optional ascending-orbit
    augmentation), NaN healing, admin-mask window (:387-458);
  * test mode: sliding-window patch grid (patchsize 2048, overlap 128,
    border patches + bottom-right corner, x4 seasons) with a validity mask
    excluding the halo (:294-334, :461-523, :656-672);
  * merged-mosaic-missing fallback: windowed reads served straight from
    the raw unmerged tiles via MosaicIndex (the reference's GDAL VRT
    auto-build, :176-263);
  * census-table preparation: skip indices, shuffled 80/20 train/val
    split with the fixed rng 1610, max-pixel filters (:93-138).

Everything returns numpy NHWC; batching/bucketing/augmentation live in
data.feed.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import pandas as pd

from ..config import (
    DATALOCATIONS,
    SEASONS,
    SKIP_INDICES,
    DataPaths,
)
from ..io.geotiff import GeoTIFF, has_nan, write_geotiff
from ..io.mosaic import MosaicIndex

Window = Tuple[Tuple[int, int], Tuple[int, int]]


ADMIN_OVERLAP = 32  # halo around each census bbox (PopulationDataset.py:404-407)


def max_census_window(ds) -> "Tuple[int, int]":
    """Largest (dx, dy) any of ``ds``'s census rows can request through
    get_admin_item/get_admin_meta (bbox + ADMIN_OVERLAP halo, clamped to
    the region) — the padding bound for device-resident feeds."""
    h, w = ds.cr_shape
    dx_max = dy_max = 1
    for bbox in ds.census["bbox"]:
        xmin, xmax, ymin, ymax = parse_bbox(bbox)
        dx_max = max(dx_max, min(xmax + ADMIN_OVERLAP, h) - max(xmin - ADMIN_OVERLAP, 0))
        dy_max = max(dy_max, min(ymax + ADMIN_OVERLAP, w) - max(ymin - ADMIN_OVERLAP, 0))
    return dx_max, dy_max


def parse_bbox(bbox_str: str) -> Tuple[int, int, int, int]:
    """Parse '(xmin, xmax, ymin, ymax)' / '[...]' census bbox strings
    (reference: PopulationDataset.py:337-346). x is the row axis."""
    vals = bbox_str.strip("()").strip("[]").split(",")
    xmin, xmax, ymin, ymax = (int(v) for v in vals)
    return xmin, xmax, ymin, ymax


def bbox_pixel_count(bbox_str: str) -> int:
    xmin, xmax, ymin, ymax = parse_bbox(bbox_str)
    return (xmax - xmin) * (ymax - ymin)


def prepare_weaksup_census(
    census_csv: str,
    region: str,
    *,
    split: str = "all",
    max_samples: Optional[int] = None,
    max_pix: float = 10_000_000,
    max_pix_box: float = 12_000_000,
) -> pd.DataFrame:
    """Census table with the reference's exact filtering and split semantics
    (PopulationDataset.py:93-138): skip indices, shuffle with rng 1610,
    80/20 train/val, then max-pixel and max-bbox filters."""
    df = pd.read_csv(census_csv)
    df = df[~df["idx"].isin(SKIP_INDICES.get(region, []))].reset_index(drop=True)
    if max_samples is not None:
        df = df.sample(frac=1, random_state=1610)[-max_samples:].reset_index(drop=True)
    if split == "train":
        df = df.sample(frac=1, random_state=1610)[: int(len(df) * 0.8)].reset_index(
            drop=True
        )
    elif split == "val":
        df = df.sample(frac=1, random_state=1610)[int(len(df) * 0.8) :].reset_index(
            drop=True
        )
    elif split != "all":
        raise ValueError(f"unknown split {split!r}")
    df = df[df["count"] < max_pix].reset_index(drop=True)
    df["bbox_count"] = df["bbox"].apply(bbox_pixel_count)
    df = df[df["bbox_count"] < max_pix_box].reset_index(drop=True)
    return df


def interpolate_nan(arr: np.ndarray) -> np.ndarray:
    """Nearest-neighbour fill of NaNs (PopulationDataset.py:526-551)."""
    from scipy.interpolate import griddata

    nan_mask = np.isnan(arr)
    if not nan_mask.any():
        return arr
    if (~nan_mask).sum() < 4:
        return np.zeros_like(arr)
    known = np.where(~nan_mask)
    missing = np.where(nan_mask)
    vals = arr[known]
    arr[missing] = griddata(
        np.vstack(known).T, vals, np.vstack(missing).T, method="nearest"
    )
    return arr


def patch_grid(
    img_shape: Tuple[int, int],
    patchsize: int,
    overlap: int,
    fourseasons: bool,
) -> np.ndarray:
    """Sliding-window patch index grid (PopulationDataset.py:294-334):
    main stride patchsize-2*overlap, plus bottom/right border rows and the
    bottom-right corner, each replicated per season. Returns (N,3) int
    array of (x, y, season)."""
    stride = patchsize - overlap * 2
    h, w = img_shape
    x = np.arange(0, h - patchsize, stride, dtype=int)
    y = np.arange(0, w - patchsize, stride, dtype=int)
    main = np.stack(np.meshgrid(x, y, indexing="ij"), -1).reshape(-1, 2)
    max_x, max_y = h - patchsize, w - patchsize
    bottom = np.stack([np.full(len(y), max_x, int), y], 1)
    right = np.stack([x, np.full(len(x), max_y, int)], 1)
    corner = np.array([[max_x, max_y]])
    xy = np.concatenate([main, bottom, right, corner], 0)
    seasons = range(4) if fourseasons else (0,)
    out = np.concatenate(
        [np.concatenate([xy, np.full((len(xy), 1), s, int)], 1) for s in seasons], 0
    )
    return out


def validity_mask(patchsize_x: int, patchsize_y: int, overlap: int) -> np.ndarray:
    """Halo-excluding validity mask (PopulationDataset.py:656-672)."""
    m = np.zeros((patchsize_x, patchsize_y), bool)
    m[overlap : patchsize_x - overlap, overlap : patchsize_y - overlap] = True
    return m


class _RasterSource:
    """A merged mosaic GeoTIFF, or a MosaicIndex over raw tiles when the
    merged file is missing (the reference's VRT fallback).

    When a pre-decoded ``.npy`` sidecar exists next to the merged file
    (io/raster_cache.py, built by tools/build_raster_cache.py), windowed
    reads become mmap page-cache slices with ZERO tile inflate — the hot
    data plane's dominant host cost on weak hosts (the
    reference's "use SSDs" warning, README.md:178, is the analogue).

    in_memory=True decodes the whole raster once and serves windows from
    RAM (the reference's --in_memory eval flag, arguments/eval.py:26) —
    windowed reads become pure numpy slices, which matters when training
    revisits overlapping census crops every epoch."""

    def __init__(
        self,
        merged_path: str,
        tile_dir: Optional[str],
        cache: Optional[str],
        in_memory: bool = False,
    ):
        from ..io.raster_cache import open_cache

        self._cache: Optional[np.memmap] = None
        if os.path.exists(merged_path):
            self._g = GeoTIFF(merged_path)
            self.shape = self._g.shape
            self.dtype = self._g.dtype
            self._cache = open_cache(merged_path)
        elif tile_dir and os.path.isdir(tile_dir):
            self._g = MosaicIndex.from_dir(tile_dir, cache=cache)
            self.shape = self._g.shape
            self.dtype = np.dtype(np.float32)
        else:
            raise FileNotFoundError(
                f"neither merged mosaic {merged_path} nor raw tiles {tile_dir} exist"
            )
        self._mem: Optional[np.ndarray] = None
        if in_memory:
            # the sidecar, when present, skips the decode here too
            self._mem = (
                self._cache[:].astype(np.float32)
                if self._cache is not None
                else self._g.read()
            )

    @staticmethod
    def _band_idx(bands):
        if isinstance(bands, int):
            bands = [bands]
        return [b - 1 for b in bands]

    def read(self, bands, window) -> np.ndarray:
        (r0, r1), (c0, c1) = window
        if self._mem is not None:
            return self._mem[self._band_idx(bands), r0:r1, c0:c1]
        if self._cache is not None:
            # fancy band index copies the window out of the mmap; the
            # astype matches the native reader's plain u16->f32 cast
            # (byte-equality pinned in tests/test_raster_cache.py)
            sl = self._cache[self._band_idx(bands), r0:r1, c0:c1]
            return sl.astype(np.float32, copy=False)
        return self._g.read(bands, window=window)

    def read_raw(self, bands, window) -> Optional[np.ndarray]:
        """Windowed read in the file's NATIVE dtype (no float conversion;
        the uint16 transport fast path), or None when this source cannot
        serve one (in-memory float copy, raw-tile mosaic fallback)."""
        if self._mem is not None:
            return None
        if self._cache is not None:
            (r0, r1), (c0, c1) = window
            return np.ascontiguousarray(
                self._cache[self._band_idx(bands), r0:r1, c0:c1]
            )
        if isinstance(self._g, GeoTIFF):
            return self._g.read(bands, window=window, raw=True)
        return None


class PopulationDataset:
    """See module docstring. mode in {'weaksup', 'test'}."""

    def __init__(
        self,
        paths: DataPaths,
        region: str,
        *,
        s1: bool = True,
        s2: bool = True,
        nir: bool = True,
        viirs: bool = False,
        patchsize: Optional[int] = 1024,
        overlap: Optional[int] = 32,
        fourseasons: bool = False,
        mode: str = "test",
        split: str = "all",
        max_samples: Optional[int] = None,
        sentinelbuildings: bool = True,
        ascfill: bool = False,
        train_level: str = "fine",
        max_pix: float = 10_000_000,
        max_pix_box: float = 12_000_000,
        asc_aug: bool = False,
        in_memory: bool = False,
    ):
        self.paths = paths
        self.region = region
        self.s1, self.s2, self.nir = s1, s2, nir
        self.viirs = viirs
        self.patchsize = patchsize
        self.overlap = overlap
        self.fourseasons = fourseasons
        self.mode = mode
        self.ascfill = ascfill
        self.asc_aug = asc_aug
        self.train_level = train_level
        self.sentinelbuildings = sentinelbuildings
        self.in_memory = in_memory

        if region not in DATALOCATIONS:
            raise ValueError(
                f"unknown region {region!r}; registered regions: "
                f"{sorted(DATALOCATIONS)} (extend popcorn_tpu_torch.config.DATALOCATIONS "
                "to add one)"
            )
        self.levels = list(DATALOCATIONS[region].keys())
        self.boundary_paths = {
            lvl: paths.boundary_path(region, lvl) for lvl in self.levels
        }
        self.census_paths = {lvl: paths.census_path(region, lvl) for lvl in self.levels}

        if mode == "weaksup":
            self.census = prepare_weaksup_census(
                self.census_paths[train_level],
                region,
                split=split,
                max_samples=max_samples,
                max_pix=max_pix,
                max_pix_box=max_pix_box,
            )
            with GeoTIFF(self.boundary_paths[train_level]) as b:
                self.cr_shape = b.shape
        elif mode == "test":
            first = self.boundary_paths[self.levels[0]]
            with GeoTIFF(first) as b:
                self.img_shape = b.shape
                self._template = first
            self.patch_indices = patch_grid(
                self.img_shape, patchsize, overlap, fourseasons
            )
        else:
            raise ValueError(f"unknown mode {mode!r}")

        # buildings source: on-the-fly Sentinel extraction (default) or the
        # pre-rasterised Google/Swiss building files (reference
        # PopulationDataset.py:269-287, 607-612)
        self._gb_counts: Optional[GeoTIFF] = None
        self._gb_seg: Optional[GeoTIFF] = None
        if not sentinelbuildings:
            cpath = paths.gbuildings_counts_path(region)
            spath = paths.gbuildings_segmentation_path(region)
            if os.path.exists(cpath):
                self._gb_counts = GeoTIFF(cpath)
            if os.path.exists(spath):
                self._gb_seg = GeoTIFF(spath)

        self._sources: Dict[Tuple[str, str, bool], _RasterSource] = {}
        self._boundary_handles: Dict[str, GeoTIFF] = {}
        # the multi-worker feeds call _source concurrently on a cold
        # dataset; an unguarded check-then-set would open duplicate native
        # handles (and with in_memory decode the whole mosaic per worker)
        self._sources_lock = threading.Lock()

    # -- raster access ----------------------------------------------------------

    def _source(self, modality: str, season_idx: int, asc: bool) -> _RasterSource:
        if modality == "viirs":
            # VIIRS is a single season-less covariate raster (reference
            # PopulationDataset.py:267); no raw-tile fallback exists for it.
            key = ("viirs", "", False)
            with self._sources_lock:
                if key not in self._sources:
                    merged = self.paths.modality_path(self.region, "viirs", "")
                    self._sources[key] = _RasterSource(
                        merged, None, None, in_memory=self.in_memory
                    )
                return self._sources[key]
        season = SEASONS[season_idx]
        key = (modality, season, asc)
        with self._sources_lock:
            if key not in self._sources:
                merged = self.paths.modality_path(self.region, modality, season, asc)
                tiles = self.paths.raw_tile_dir(self.region, modality, season, asc)
                cache = self.paths.mosaic_index_path(self.region, modality, season, asc)
                self._sources[key] = _RasterSource(
                    merged, tiles, cache, in_memory=self.in_memory
                )
            return self._sources[key]

    def _boundary(self, level: str) -> GeoTIFF:
        with self._sources_lock:
            if level not in self._boundary_handles:
                self._boundary_handles[level] = GeoTIFF(self.boundary_paths[level])
            return self._boundary_handles[level]

    def generate_raw_data(
        self,
        x: int,
        y: int,
        season_idx: int,
        *,
        patchsize: Optional[Tuple[int, int]] = None,
        admin_overlap: int = 0,
        descending: bool = True,
    ) -> Tuple[Dict[str, np.ndarray], Window]:
        """Windowed modality reads, HWC float32 (PopulationDataset.py:554-621).

        S2 band order (3,2,1[,4]) = (R,G,B[,NIR]); S1 (1,2) = (VV,VH).
        """
        psx = self.patchsize if patchsize is None else patchsize[0]
        psy = self.patchsize if patchsize is None else patchsize[1]
        if admin_overlap > 0:
            x0 = max(x - admin_overlap, 0)
            y0 = max(y - admin_overlap, 0)
            x1 = min(x + psx + admin_overlap, self.cr_shape[0])
            y1 = min(y + psy + admin_overlap, self.cr_shape[1])
            window: Window = ((x0, x1), (y0, y1))
        else:
            window = ((x, x + psx), (y, y + psy))

        indata: Dict[str, np.ndarray] = {}
        if self.s2:
            bands = (3, 2, 1, 4) if self.nir else (3, 2, 1)
            arr = self._source("S2", season_idx, False).read(bands, window)
            indata["S2"] = np.transpose(arr, (1, 2, 0))
        if self.s1:
            arr = self._source("S1", season_idx, asc=not descending).read((1, 2), window)
            indata["S1"] = np.transpose(arr, (1, 2, 0))
        if self.viirs:
            arr = self._source("viirs", 0, False).read((1,), window)
            indata["VIIRS"] = np.transpose(arr, (1, 2, 0))
        if self._gb_counts is not None:
            indata["building_counts"] = self._gb_counts.read(1, window=window)[0]
        if self._gb_seg is not None:
            indata["building_segmentation"] = self._gb_seg.read(1, window=window)[0]
        return indata, window

    def _heal(self, indata: Dict[str, np.ndarray], x, y, season_idx, patchsize, admin_overlap):
        """NaN healing with ascending-orbit refetch fallback
        (PopulationDataset.py:418-441, 483-500)."""
        if "S2" in indata and has_nan(indata["S2"]):
            indata["S2"] = interpolate_nan(indata["S2"])
        if "S1" in indata and has_nan(indata["S1"]):
            frac = np.isnan(indata["S1"]).mean()
            if frac < 0.05 and not self.ascfill:
                indata["S1"] = interpolate_nan(indata["S1"])
            else:
                asc, _ = self.generate_raw_data(
                    x, y, season_idx, patchsize=patchsize,
                    admin_overlap=admin_overlap, descending=False,
                )
                indata["S1"] = asc["S1"]
                frac = np.isnan(indata["S1"]).mean()
                if frac > 0:
                    if frac < 0.05:
                        indata["S1"] = interpolate_nan(indata["S1"])
                    else:
                        raise ValueError("No data here! (S1 too many NaNs)")
        return indata

    # -- item access -------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.patch_indices) if self.mode == "test" else len(self.census)

    def get_admin_item(self, index: int, rng: np.random.Generator) -> Dict:
        """One census-region training sample (PopulationDataset.py:387-458)."""
        row = self.census.iloc[index]
        xmin, xmax, ymin, ymax = parse_bbox(row["bbox"])
        season_idx = int(rng.integers(0, 4)) if self.fourseasons else 0
        descending = bool(rng.integers(0, 2)) if self.asc_aug else True
        ad_over = ADMIN_OVERLAP

        indata, window = self.generate_raw_data(
            xmin,
            ymin,
            season_idx,
            patchsize=(xmax - xmin, ymax - ymin),
            admin_overlap=ad_over,
            descending=descending,
        )
        indata = self._heal(indata, xmin, ymin, season_idx, (xmax - xmin, ymax - ymin), ad_over)

        admin = self._boundary(self.train_level).read(1, window=window)[0]

        return {
            **indata,
            "y": np.float32(row["POP20"]),
            "admin_mask": admin.astype(np.float32),
            "img_coords": (xmin, ymin),
            "valid_coords": (xmin, xmax, ymin, ymax),
            "season": season_idx,
            "census_idx": np.float32(row["idx"]),
        }

    def get_admin_meta(self, index: int, rng: np.random.Generator) -> Dict:
        """Metadata of one census-region sample WITHOUT raster reads: the
        same rng draws, window arithmetic and scalar fields as
        get_admin_item, in the same order — for feeds that assemble the
        pixels on device, where the host only needs coordinates."""
        row = self.census.iloc[index]
        xmin, xmax, ymin, ymax = parse_bbox(row["bbox"])
        season_idx = int(rng.integers(0, 4)) if self.fourseasons else 0
        descending = bool(rng.integers(0, 2)) if self.asc_aug else True
        ad_over = ADMIN_OVERLAP
        x0 = max(xmin - ad_over, 0)
        y0 = max(ymin - ad_over, 0)
        x1 = min(xmax + ad_over, self.cr_shape[0])
        y1 = min(ymax + ad_over, self.cr_shape[1])
        return {
            "x0": x0,
            "y0": y0,
            "dx": x1 - x0,
            "dy": y1 - y0,
            "season": season_idx,
            "descending": descending,
            "y": np.float32(row["POP20"]),
            "census_idx": np.float32(row["idx"]),
        }

    def get_test_item(self, index: int) -> Dict:
        """One sliding-window patch (PopulationDataset.py:461-523)."""
        x, y, season_idx = (int(v) for v in self.patch_indices[index])
        indata, _ = self.generate_raw_data(x, y, int(season_idx))
        indata = self._heal(indata, x, y, int(season_idx), None, 0)
        if "S1" in indata and "S2" in indata:
            if indata["S1"].shape[:2] != indata["S2"].shape[:2]:
                raise ValueError("S1 and S2 have different shapes")
        mask = validity_mask(self.patchsize, self.patchsize, self.overlap)
        return {
            **indata,
            "img_coords": (x, y),
            "valid_coords": (
                x + self.overlap,
                x + self.patchsize - self.overlap,
                y + self.overlap,
                y + self.patchsize - self.overlap,
            ),
            "season": int(season_idx),
            "mask": mask,
        }

    def shape(self) -> Tuple[int, int]:
        return self.img_shape

    def save(self, preds: np.ndarray, output_folder: str, tag: str = "") -> None:
        """Write a prediction map as GeoTIFF with the boundary raster's
        georeferencing (PopulationDataset.py:855-880)."""
        os.makedirs(output_folder, exist_ok=True)
        out = os.path.join(output_folder, f"{self.region}_predictions{tag}.tif")
        write_geotiff(out, np.asarray(preds, np.float32), template=self._template)

    def close(self):
        for g in self._boundary_handles.values():
            g.close()
        self._boundary_handles.clear()
        self._sources.clear()
        for g in (self._gb_counts, self._gb_seg):
            if g is not None:
                g.close()
        self._gb_counts = self._gb_seg = None
