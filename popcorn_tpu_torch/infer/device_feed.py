"""Device-resident season mosaics for country-scale sliding-window eval.

Counterpart of popcorn_tpu/infer/device_feed.py. The host feed
(data/feed.py::InferenceFeed) reads, assembles and uploads every 2048^2
patch — and the patches overlap, so about 30% of those bytes are
neighbours sent again. Country-season mosaics are small next to the
card's memory (a 9216^2 four-band uint16 season is about 680 MB), so
each season's mosaics upload ONCE and the sliding window crops its
patches on the device, feeding the very same patch forward
(infer/sliding.py::_run_device_feed_pass).

Bit-exactness: crops are pure slices of the same mosaic values the host
path reads, in the host feed's transport dtypes (uint16 S2 when the float
round trip is lossless, data/feed.py), so the forward sees the same
tensors. NaN-bearing seasons run hybrid: patches whose window overlaps a
NaN tile take the host feed's healing path (PopulationDataset.py:418-441).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data.dataset import PopulationDataset
from ..data.feed import widen_u16


def _read_raw_u16(src, bands, window) -> Optional[np.ndarray]:
    """Raw uint16 window read from a _RasterSource when the stored dtype
    is uint16 — served from the pre-decoded mmap sidecar when one exists
    (io/raster_cache.py), else a native raw decode; None when
    unsupported (in-memory float copy, mosaic fallback, other dtypes) —
    the caller uses the float path."""
    if np.dtype(getattr(src, "dtype", np.float32)) != np.uint16:
        return None
    return src.read_raw(bands, window)


def season_arrays(dataset: PopulationDataset, season_idx: int, transport: str = "exact"):
    """Full-season modality mosaics as CHW arrays in transport dtype.

    Returns ``(mosaics, nan_tiles)``: ``nan_tiles`` maps a healed
    modality (S2/S1) to a tile-level summed-area table of its NaN pixels
    ({} when the season is clean). Patches whose window overlaps a NaN
    tile need the reference's per-patch healing (host feed,
    PopulationDataset.py:418-441); every other patch crops from the
    (possibly NaN-bearing) resident mosaics — its window provably holds
    no NaN, so the values are identical to a host-healed read.

    S2 rides uint16 when the float32 round trip is lossless (the mosaics
    are stored uint16, reference README.md:245) — half the upload bytes;
    S1, VIIRS and building counts ride float32, and under
    ``transport="bf16"`` the float image modalities ride as CPU
    torch.bfloat16 tensors (data/feed.py::transport_cast).
    """
    from ..data.device_weaksup import _nan_tile_integral
    from ..data.feed import transport_cast

    h, w = dataset.shape()
    window = ((0, h), (0, w))
    out: Dict[str, np.ndarray] = {}
    nan_q: Dict[str, np.ndarray] = {}
    if dataset.s2:
        bands = (3, 2, 1, 4) if dataset.nir else (3, 2, 1)
        src = dataset._source("S2", season_idx, False)
        arr = _read_raw_u16(src, bands, window)
        if arr is not None:
            # native uint16 mosaic read raw: no float detour, no NaN
            # possible, and already in the transport dtype
            out["S2"] = arr
        else:
            arr = src.read(bands, window)
            q = _nan_tile_integral(arr)
            if q is not None:
                nan_q["S2"] = q
                out["S2"] = np.ascontiguousarray(arr, np.float32)
            else:
                u16 = arr.astype(np.uint16)
                out["S2"] = u16 if np.array_equal(u16, arr) else arr
    if dataset.s1:
        arr = dataset._source("S1", season_idx, asc=False).read((1, 2), window)
        q = _nan_tile_integral(arr)
        if q is not None:
            nan_q["S1"] = q
        out["S1"] = np.ascontiguousarray(arr, np.float32)
    if dataset.viirs:
        # VIIRS is not healed by the reference's test path either
        # (PopulationDataset.py:461-523) — shipped raw for bit-parity
        arr = dataset._source("viirs", 0, False).read((1,), window)
        out["VIIRS"] = np.ascontiguousarray(arr, np.float32)
    if dataset._gb_counts is not None:
        arr = dataset._gb_counts.read(1, window=window)
        out["building_counts"] = np.ascontiguousarray(arr, np.float32)
    # the transport cast comes AFTER the NaN tables: bf16 keeps NaN, but
    # the tables scan float32
    return transport_cast(out, transport), nan_q


def make_device_crop(patch: int, channels_last_keys=("S2", "S1", "VIIRS")):
    """(mosaics, x, y) -> batch-of-1 patch dict, entirely on the device.

    ``mosaics`` are the resident CHW tensors (uint16 S2 as its int16 bit
    view); ``x``, ``y`` are Python ints, so a crop needs no scalar tensor
    and no synchronisation. Crops come out contiguous in the NHWC layout
    of the host feed's upload (uint16 widened to int32, as
    infer/sliding.py::_upload widens it); `building_counts` stays
    (1, H, W) to match the host feed's shape.
    """

    def crop(mosaics: Dict[str, torch.Tensor], x: int, y: int) -> Dict[str, torch.Tensor]:
        batch = {}
        for k, a in mosaics.items():
            sl = a[:, x : x + patch, y : y + patch]
            if k in channels_last_keys:
                t = sl.permute(1, 2, 0).unsqueeze(0).contiguous()
            else:  # building_counts: (1, H, W) like the host feed
                t = sl[:1].contiguous()
            batch[k] = widen_u16(t) if t.dtype == torch.int16 else t
        return batch

    return crop
