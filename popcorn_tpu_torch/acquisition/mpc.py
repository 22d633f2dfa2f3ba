"""Microsoft Planetary Computer acquisition (auth-free alternative).

Native re-build of the reference's MPC download
(utils/01_download_mpc_country.py): STAC search over
sentinel-2-l2a, SCL-based cloud masking, per-season temporal median,
uint16 + compressed GeoTIFF output ("up to 4x reduction vs float32",
reference README.md:245).

The pure numerics (SCL mask classes, masked temporal median, uint16
conversion) are plain numpy and unit-tested; the network layer
(pystac-client / planetary-computer) is imported lazily.

Counterpart of popcorn_tpu/acquisition/mpc.py, copied with relative imports.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .common import season_windows

# SCL classes treated as clouds (reference 01_download_mpc_country.py:70-80):
# 0 nodata, 8 cloud medium prob, 9 cloud high prob, 10 thin cirrus.
SCL_CLOUD_CLASSES = (0, 8, 9, 10)
S2_L2A_BANDS = ("B02", "B03", "B04", "B08")
DEFAULT_RESOLUTION_DEG = 1e-4


def scl_cloud_mask(scl: np.ndarray) -> np.ndarray:
    """True where the pixel is cloudy/invalid per the SCL band."""
    return np.isin(scl, SCL_CLOUD_CLASSES)


def masked_temporal_median(
    stack: np.ndarray, cloud_mask: np.ndarray
) -> np.ndarray:
    """Median over time with cloudy observations excluded.

    stack: (T, C, H, W) float; cloud_mask: (T, H, W) bool.
    Pixels cloudy at every date become 0 (matching uint16 nodata).
    """
    import warnings

    m = np.broadcast_to(cloud_mask[:, None], stack.shape)
    data = np.where(m, np.nan, stack)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        med = np.nanmedian(data, axis=0)
    return np.nan_to_num(med, nan=0.0)


def to_uint16(arr: np.ndarray) -> np.ndarray:
    """Clip reflectance to the uint16 range (reference stores uint16+LZW)."""
    return np.clip(np.round(arr), 0, 65535).astype(np.uint16)


def _stac():
    try:
        import planetary_computer
        import pystac_client
    except ImportError as e:
        raise ImportError(
            "pystac-client + planetary-computer are required for MPC "
            "downloads (pip install pystac-client planetary-computer)."
        ) from e
    return pystac_client, planetary_computer


def download_seasonal_composite(
    bbox: Tuple[float, float, float, float],
    season: str,
    out_path: str,
    *,
    year: int = 2020,
    max_cloud_pct: int = 60,
    resolution: float = DEFAULT_RESOLUTION_DEG,
    chunk_px: int = 2048,
):
    """Build one seasonal cloud-masked median composite from MPC and write
    it as uint16 GeoTIFF. Requires network access + STAC packages."""
    pystac_client, planetary_computer = _stac()
    import rasterio  # pragma: no cover - only on MPC-capable systems

    start, end = season_windows(year)[season]
    catalog = pystac_client.Client.open(
        "https://planetarycomputer.microsoft.com/api/stac/v1",
        modifier=planetary_computer.sign_inplace,
    )
    search = catalog.search(
        collections=["sentinel-2-l2a"],
        bbox=bbox,
        datetime=f"{start}/{end}",
        query={"eo:cloud_cover": {"lt": max_cloud_pct}},
    )
    items = list(search.items())
    if not items:
        raise RuntimeError(f"no sentinel-2-l2a items for {bbox} {start}..{end}")

    # Read band stacks per item, mask with SCL, median, write uint16.
    from ..io.geotiff import write_geotiff

    stacks, masks = [], []
    for item in items:
        bands = []
        for b in S2_L2A_BANDS:
            with rasterio.open(item.assets[b].href) as src:
                bands.append(src.read(1, out_dtype="float32"))
        with rasterio.open(item.assets["SCL"].href) as src:
            scl = src.read(1)
        stacks.append(np.stack(bands))
        masks.append(scl_cloud_mask(scl))
    med = masked_temporal_median(np.stack(stacks), np.stack(masks))
    write_geotiff(
        out_path,
        med.astype(np.float32),
        transform=(bbox[0], resolution, bbox[3], resolution),
        dtype=np.uint16,
        nodata=0.0,
    )
    return out_path
