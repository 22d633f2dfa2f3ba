"""Polygon rasterization and region matching in pure numpy.

Native replacement for the geopandas/rasterio.features machinery the
reference's census preprocessing uses (utils/02_preprocess_rwa_shapefile.py):

  * scanline even-odd polygon fill onto a georeferenced grid (holes work
    without winding conventions);
  * admin-polygon <-> census-polygon matching by rasterized IoU with the
    reference's 0.66 threshold (:72-104);
  * per-region bbox + pixel-count extraction (:146-161) — the quantities
    the training census CSV carries;
  * block-pooling of fine grids to coarser evaluation levels (:194-327).

Counterpart of popcorn_tpu/geo/rasterize.py, copied with relative imports.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from .shapefile import PolygonRings

# origin_x, px_w, origin_y, px_h: GeoTIFF.transform gives a north-up px_h
# (< 0); world_to_pixel divides by either sign
Transform = Tuple[float, float, float, float]


def world_to_pixel(xs, ys, t: Transform):
    ox, pw, oy, ph = t
    return (np.asarray(ys) - oy) / ph, (np.asarray(xs) - ox) / pw  # (row, col)


def rasterize_polygon(
    rings: PolygonRings, shape: Tuple[int, int], t: Transform
) -> np.ndarray:
    """Even-odd scanline fill; a pixel is inside iff its CENTER is inside."""
    h, w = shape
    mask = np.zeros((h, w), bool)
    if not rings:
        return mask
    # collect all edges in pixel coordinates
    edges = []
    for ring in rings:
        r, c = world_to_pixel(ring[:, 0], ring[:, 1], t)
        pts = np.stack([r, c], 1)
        e0 = pts
        e1 = np.roll(pts, -1, axis=0)
        keep = e0[:, 0] != e1[:, 0]  # skip horizontal edges
        edges.append((e0[keep], e1[keep]))
    if not edges:
        return mask
    a = np.concatenate([e[0] for e in edges])
    b = np.concatenate([e[1] for e in edges])
    r0 = np.minimum(a[:, 0], b[:, 0])
    r1 = np.maximum(a[:, 0], b[:, 0])
    row_lo = max(int(np.floor(r0.min() - 0.5)), 0)
    row_hi = min(int(np.ceil(r1.max() + 0.5)), h - 1)
    for row in range(row_lo, row_hi + 1):
        yc = row + 0.5
        sel = (r0 <= yc) & (yc < r1)  # half-open rule avoids double counting
        if not sel.any():
            continue
        aa, bb = a[sel], b[sel]
        xs = aa[:, 1] + (yc - aa[:, 0]) * (bb[:, 1] - aa[:, 1]) / (bb[:, 0] - aa[:, 0])
        xs.sort()
        for i in range(0, len(xs) - 1, 2):
            c0 = int(np.ceil(xs[i] - 0.5))
            c1 = int(np.floor(xs[i + 1] - 0.5))
            if c1 >= c0:
                mask[row, max(c0, 0) : min(c1, w - 1) + 1] = True
    return mask


def rasterize_regions(
    geoms: Sequence[PolygonRings],
    ids: Sequence[float],
    shape: Tuple[int, int],
    t: Transform,
    background: float = 0.0,
) -> np.ndarray:
    """Burn region IDs onto a grid (later polygons overwrite earlier)."""
    out = np.full(shape, background, np.float32)
    for rings, rid in zip(geoms, ids):
        m = rasterize_polygon(rings, shape, t)
        out[m] = rid
    return out


def region_bbox_counts(id_raster: np.ndarray, ids: Sequence[float]):
    """Per-region bbox '(xmin, xmax, ymin, ymax)' strings and pixel counts
    (the GPU pass of the reference :146-161, vectorised on host).

    Returns dict id -> (bbox_str or None, count).
    """
    out = {}
    for rid in ids:
        rows, cols = np.nonzero(id_raster == rid)
        if len(rows) == 0:
            out[rid] = (None, 0)
            continue
        bbox = f"[{rows.min()}, {rows.max() + 1}, {cols.min()}, {cols.max() + 1}]"
        out[rid] = (bbox, int(len(rows)))
    return out


def match_regions_by_iou(
    geoms_a: Sequence[PolygonRings],
    geoms_b: Sequence[PolygonRings],
    shape: Tuple[int, int],
    t: Transform,
    threshold: float = 0.66,
) -> Dict[int, int]:
    """Match polygons of layer A to layer B by rasterized IoU
    (reference threshold 0.66, 02_preprocess_rwa_shapefile.py:72-104).

    Returns {index_a: index_b} for pairs whose IoU >= threshold.
    """
    ra = np.zeros(shape, np.int32)
    for i, g in enumerate(geoms_a):
        ra[rasterize_polygon(g, shape, t)] = i + 1
    rb = np.zeros(shape, np.int32)
    for j, g in enumerate(geoms_b):
        rb[rasterize_polygon(g, shape, t)] = j + 1

    na, nb = len(geoms_a) + 1, len(geoms_b) + 1
    pair = ra.astype(np.int64) * nb + rb.astype(np.int64)
    counts = np.bincount(pair.ravel(), minlength=na * nb).reshape(na, nb)
    area_a = counts.sum(1)
    area_b = counts.sum(0)
    matches: Dict[int, int] = {}
    for i in range(1, na):
        inter = counts[i, 1:]
        if inter.max(initial=0) == 0:
            continue
        j = int(np.argmax(inter)) + 1
        union = area_a[i] + area_b[j] - counts[i, j]
        if union > 0 and counts[i, j] / union >= threshold:
            matches[i - 1] = j - 1
    return matches


def block_pool_sum(arr: np.ndarray, factor: int) -> np.ndarray:
    """Pool a fine grid to a coarser level by block sum (the Kigali
    100m -> 200..1000m pooling, reference :194-327). Truncates edges."""
    h, w = arr.shape
    h2, w2 = h // factor * factor, w // factor * factor
    v = arr[:h2, :w2].reshape(h2 // factor, factor, w2 // factor, factor)
    return v.sum((1, 3))
