"""Built-up-probability time series from dated single frames.

Counterpart of popcorn_tpu/infer/timeseries.py (the intended behaviour of
the reference's time_series_inference_single_frame.py, which is
bit-rotted): for each dated Sentinel-2 frame, pair it with the
nearest-dated Sentinel-1 descending and ascending frames, compute the
frozen DDA built-up probability for each orbit, average them, and write
``BuiltUp_<date>.tif``, to monitor construction or destruction over time.

The score is nn/popcorn.py::create_building_score in the model's compute
dtype on ``device`` (the card by default): on CUDA every DoubleConv of the
extractor is kernel A and every Up block kernel B (6 A and 4 B a call).
Frames larger than the patch are scored in overlap-stitched patches.
With ``mesh=`` each frame is scored whole instead (infer/spatial.py, its
rows split over the mesh's data ranks), as with the JAX package's mesh:
no patches, and a true score in the frame's outer ring, which the patch
stitch leaves 0. Only rank 0 writes the GeoTIFFs.
"""

from __future__ import annotations

import dataclasses
import datetime as dt
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..compat.weights import to_torch
from ..config import ModelConfig
from ..data.dataset import interpolate_nan, patch_grid, validity_mask
from ..data.normalize import NormStats, normalize_and_assemble
from ..io.geotiff import GeoTIFF, has_nan, write_geotiff
from ..nn.popcorn import compute_dtype, create_building_score
from .sliding import resolve_device

Tree = Dict


@dataclasses.dataclass
class Frame:
    date: dt.date
    path: str


def parse_date(s: str) -> dt.date:
    for fmt in ("%Y-%m-%d", "%Y%m%d"):
        try:
            return dt.datetime.strptime(s, fmt).date()
        except ValueError:
            continue
    raise ValueError(f"unparseable date {s!r}")


def find_closest_frames(
    s2_frames: Sequence[Frame],
    s1_desc_frames: Sequence[Frame],
    s1_asc_frames: Sequence[Frame],
) -> List[Tuple[Frame, Optional[Frame], Optional[Frame]]]:
    """Pair each S2 frame with its nearest-dated S1 desc and asc frames
    (reference intent: time_series_inference_single_frame.py:104-148).
    A missing orbit pairs as None: the built-up score then uses the
    available orbit alone. No S1 frame at all raises."""

    def closest(frames: Sequence[Frame], date: dt.date) -> Optional[Frame]:
        if not frames:
            return None
        return min(frames, key=lambda f: abs((f.date - date).days))

    pairs = [
        (s2, closest(s1_desc_frames, s2.date), closest(s1_asc_frames, s2.date))
        for s2 in s2_frames
    ]
    if any(d is None and a is None for _, d, a in pairs):
        raise ValueError("no S1 frames given (need s1_desc and/or s1_asc)")
    return pairs


def _read_frame(path: str, bands) -> np.ndarray:
    with GeoTIFF(path) as g:
        arr = g.read(bands)
    arr = np.transpose(arr, (1, 2, 0)).astype(np.float32)
    if has_nan(arr):
        arr = interpolate_nan(arr)
    return arr


def make_score_fn(consts: Tree, mcfg: ModelConfig, stats: Optional[NormStats] = None,
                  device="cuda"):
    """fn(s2, s1) -> (H, W) float32 numpy built-up probability of one HWC
    frame or patch: normalize, then the frozen extractor in
    ``compute_dtype(mcfg)`` on ``device``."""
    dev = resolve_device(device)
    builder = to_torch(consts["builder"], dev)
    stats = stats if stats is not None and stats.device == dev else NormStats(device=dev)
    dtype = compute_dtype(mcfg)

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)[None]).to(dev)

    @torch.no_grad()
    def fn(s2: np.ndarray, s1: np.ndarray) -> np.ndarray:
        x = normalize_and_assemble({"S2": upload(s2), "S1": upload(s1)}, stats)
        score = create_building_score(builder, x, s1=mcfg.s1, s2=mcfg.s2, nir=mcfg.nir,
                                      dtype=dtype)
        return score[0].cpu().numpy()

    return fn


def builtup_map(
    consts: Tree,
    mcfg: ModelConfig,
    s2: np.ndarray,
    s1: np.ndarray,
    *,
    stats: Optional[NormStats] = None,
    patchsize: int = 1024,
    overlap: int = 64,
    mesh=None,
    device="cuda",
    _score_fn=None,
) -> np.ndarray:
    """Built-up probability for one frame (HWC inputs): one call when the
    frame fits the patch, else overlap-stitched patches
    (``patch_grid(fourseasons=False)``, halo-excluding validity masks).
    With ``mesh`` the whole frame in one call (infer/spatial.py::
    spatial_builtup_map; ``_score_fn`` then from make_spatial_builtup)."""
    if mesh is not None:
        from .spatial import spatial_builtup_map

        return spatial_builtup_map(consts, mcfg, s2, s1, mesh, stats=stats, _fn=_score_fn)
    fn = _score_fn or make_score_fn(consts, mcfg, stats, device)
    h, w = s2.shape[:2]
    if h <= patchsize and w <= patchsize:
        return fn(s2, s1)

    grid = patch_grid((h, w), patchsize, overlap, fourseasons=False)
    acc = np.zeros((h, w), np.float32)
    cnt = np.zeros((h, w), np.float32)
    mask = validity_mask(patchsize, patchsize, overlap).astype(np.float32)
    for x, y, _ in grid:
        x, y = int(x), int(y)
        sl = (slice(x, x + patchsize), slice(y, y + patchsize))
        acc[sl] += fn(s2[sl], s1[sl]) * mask
        cnt[sl] += mask
    return np.where(cnt > 0, acc / np.maximum(cnt, 1), 0.0)


def run_builtup_timeseries(
    consts: Tree,
    mcfg: ModelConfig,
    pairs: Sequence[Tuple[Frame, Optional[Frame], Optional[Frame]]],
    output_dir: str,
    *,
    stats: Optional[NormStats] = None,
    patchsize: int = 1024,
    overlap: int = 64,
    mesh=None,
    device="cuda",
) -> List[str]:
    """Write BuiltUp_<date>.tif per (S2, S1desc, S1asc) triple, the mean of
    the available orbits' probabilities (reference intent :340-372), with
    the S2 frame's georeferencing. Returns the paths written. ``mesh``:
    each whole frame over the mesh's data ranks instead of patches (see
    builtup_map); rank 0 writes."""
    root = mesh is None or mesh.is_root
    if root:
        os.makedirs(output_dir, exist_ok=True)
    if mesh is not None:
        from .spatial import make_spatial_builtup

        fn = make_spatial_builtup(consts, mcfg, mesh, stats)
    else:
        fn = make_score_fn(consts, mcfg, stats, device)
    s2_bands = (3, 2, 1, 4) if mcfg.nir else (3, 2, 1)
    written = []
    for s2f, descf, ascf in pairs:
        s2 = _read_frame(s2f.path, s2_bands)
        scores = []
        for s1f in (descf, ascf):
            if s1f is None:
                continue  # orbit absent: use the available one alone
            s1 = _read_frame(s1f.path, (1, 2))
            if s1.shape[:2] != s2.shape[:2]:
                raise ValueError(f"S1 {s1f.path} and S2 {s2f.path} shapes differ")
            scores.append(builtup_map(consts, mcfg, s2, s1, stats=stats, patchsize=patchsize,
                                      overlap=overlap, mesh=mesh, _score_fn=fn))
        avg = sum(scores) / float(len(scores))
        out = os.path.join(output_dir, f"BuiltUp_{s2f.date.isoformat()}.tif")
        if root:
            write_geotiff(out, avg, template=s2f.path)
        written.append(out)
    return written
