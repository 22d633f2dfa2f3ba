"""Census-level aggregation and dasymmetric adjustment.

Counterpart of popcorn_tpu/agg/census_agg.py. The reference aggregates a
country-scale map to census regions with a per-region Python loop
(data/PopulationDataset.py:675-820) and adjusts the map region by region
(:823-852). Here both are single vectorised passes:

  * region IDs in the boundary raster are remapped on the host to a
    compact [0..K) range (np.searchsorted over the sorted census ids, with
    a dump bucket K for non-census pixels);
  * aggregation is one segment sum (``index_add_``) on the device that
    holds the map, accumulated in float64;
  * adjustment is a per-pixel gather of the per-region scale and one
    multiply.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import pandas as pd
import torch


def compact_ids(boundary: np.ndarray, census_idx: np.ndarray) -> Tuple[np.ndarray, int, np.ndarray]:
    """Map float region-ID raster values to compact int32 [0..K], where K
    (the last bucket) collects pixels whose ID is not in the census.
    Also returns K and the argsort of ``census_idx``."""
    sorted_idx = np.sort(census_idx.astype(np.float64))
    k = len(sorted_idx)
    b = boundary.astype(np.float64)
    pos = np.clip(np.searchsorted(sorted_idx, b), 0, k - 1)
    comp = np.where(sorted_idx[pos] == b, pos, k).astype(np.int32)
    order = np.argsort(census_idx.astype(np.float64), kind="stable")
    return comp, k, order


def _segment_sums(pred: torch.Tensor, comp: torch.Tensor, k: int) -> torch.Tensor:
    """Per-bucket sums of ``pred`` over the K+1 buckets of ``comp``."""
    total = torch.zeros(k + 1, dtype=torch.float64, device=pred.device)
    return total.index_add_(0, comp.reshape(-1), pred.reshape(-1).to(torch.float64))


def region_sums(pred: np.ndarray, boundary: np.ndarray, census_idx: np.ndarray) -> np.ndarray:
    """Sum a host map over each census region with one segment sum.
    Returns float32 sums in ``census_idx`` order."""
    comp, k, order = compact_ids(boundary, census_idx)
    p = torch.as_tensor(np.asarray(pred, np.float32))
    total = _segment_sums(p, torch.as_tensor(comp.astype(np.int64)), k).numpy()
    out = np.empty(k, np.float64)
    out[order] = total[:k]
    return out.astype(np.float32)


def convert_popmap_to_census(
    pred: np.ndarray, boundary: np.ndarray, census: pd.DataFrame
) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregate a prediction map to census counts
    (reference: PopulationDataset.py:675-729). Rows with a null bbox are
    excluded, as the reference's -1 initialise-and-filter does."""
    valid = ~census["bbox"].isna().to_numpy()
    sums = region_sums(pred, boundary, census["idx"].to_numpy())
    return sums[valid].astype(np.float32), census["POP20"].to_numpy(np.float32)[valid]


def _scale_lut(sums: np.ndarray, pop: np.ndarray, valid: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Per-bucket (sorted-id order) scale pop/sum; 1 where the sum is 0,
    the row has no bbox, and in the non-census bucket."""
    k = len(sums)
    scale = np.ones(k + 1, np.float32)
    nz = (sums > 0) & valid
    scale[:k][nz] = (pop[nz] / sums[nz]).astype(np.float32)
    lut = np.ones(k + 1, np.float32)
    lut[:k] = scale[:k][order]
    return lut


def adjust_map_to_census(pred: np.ndarray, boundary: np.ndarray, census: pd.DataFrame) -> np.ndarray:
    """Dasymmetric adjustment: rescale each region so its total matches the
    census count (reference: PopulationDataset.py:823-852). Regions whose
    predicted total is 0 (and non-census pixels) are left unchanged."""
    idx = census["idx"].to_numpy()
    valid = ~census["bbox"].isna().to_numpy()
    sums = region_sums(pred, boundary, idx)
    comp, _, order = compact_ids(boundary, idx)
    lut = _scale_lut(sums, census["POP20"].to_numpy(np.float64), valid, order)
    return np.asarray(pred, np.float32) * lut[comp]


class DeviceCensus:
    """Census aggregation against a map that lives on a device.

    The compact per-pixel region index is uploaded once; every aggregation
    is then one device segment sum and every adjustment one gather and
    multiply, and the map never leaves the device."""

    def __init__(self, boundary: np.ndarray, census: pd.DataFrame, device):
        idx = census["idx"].to_numpy()
        comp, self.k, self.order = compact_ids(boundary, idx)
        self.valid = ~census["bbox"].isna().to_numpy()
        self.pop = census["POP20"].to_numpy(np.float64)
        self.device = torch.device(device)
        self._comp = torch.as_tensor(comp.astype(np.int64), device=self.device)

    def sums(self, pred: torch.Tensor) -> np.ndarray:
        """Per-region sums of a device map, in census row order."""
        total = _segment_sums(pred, self._comp, self.k).cpu().numpy()
        out = np.empty(self.k, np.float64)
        out[self.order] = total[: self.k]
        return out.astype(np.float32)

    def convert(self, pred: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """Device counterpart of convert_popmap_to_census."""
        sums = self.sums(pred)
        return sums[self.valid].astype(np.float32), self.pop.astype(np.float32)[self.valid]

    def adjust(self, pred: torch.Tensor) -> torch.Tensor:
        """Device counterpart of adjust_map_to_census; returns a device map."""
        lut = _scale_lut(self.sums(pred), self.pop, self.valid, self.order)
        return pred * torch.as_tensor(lut, device=self.device)[self._comp]


def detail_maps(pred: np.ndarray, boundary: np.ndarray, census: pd.DataFrame) -> Dict[str, np.ndarray]:
    """Per-region diagnostic maps (reference: PopulationDataset.py:731-814):
    predicted/gt densities and totals, residuals and per-pixel-relative
    residuals, painted back onto the raster."""
    idx = census["idx"].to_numpy()
    sums = region_sums(pred, boundary, idx)
    pop = census["POP20"].to_numpy(np.float64)
    cnt = np.maximum(census["count"].to_numpy(np.float64), 1)
    comp, k, order = compact_ids(boundary, idx)

    def paint(per_region: np.ndarray) -> np.ndarray:
        lut = np.zeros(k + 1, np.float32)
        lut[:k] = per_region.astype(np.float32)[order]
        return lut[comp]

    res_rel = (sums - pop) / cnt
    res_rel[~np.isfinite(res_rel)] = 0
    return {
        "densities": paint(sums / cnt),
        "totals": paint(sums),
        "densities_gt": paint(pop / cnt),
        "totals_gt": paint(pop),
        "residuals": paint(sums - pop),
        "residuals_rel": paint(res_rel),
    }
