"""Sentinel Hub single-frame acquisition (refugee-camp workflow).

Native re-build of the reference's utils/download_sentinelhub.py: dated
single frames for small AOIs, recursive bbox splitting to <=2500px tiles,
per-modality evalscripts, and mosaic merging — the merge uses the
first-party MosaicIndex instead of GDAL BuildVRT/Translate (:176-194).

Counterpart of popcorn_tpu/acquisition/sentinel_hub.py, copied with relative imports.
"""

from __future__ import annotations

import os

from .common import BBox, split_bbox

EVALSCRIPT_S2 = """//VERSION=3
function setup() {
  return {
    input: [{bands: ["B02", "B03", "B04", "B08"], units: "DN"}],
    output: {bands: 4, sampleType: "UINT16"}
  };
}
function evaluatePixel(s) { return [s.B02, s.B03, s.B04, s.B08]; }
"""

EVALSCRIPT_S1 = """//VERSION=3
function setup() {
  return {
    input: [{bands: ["VV", "VH"]}],
    output: {bands: 2, sampleType: "FLOAT32"}
  };
}
function evaluatePixel(s) {
  return [10 * Math.log(s.VV) / Math.LN10, 10 * Math.log(s.VH) / Math.LN10];
}
"""


def _sh():
    try:
        import sentinelhub
    except ImportError as e:
        raise ImportError(
            "sentinelhub is required for Sentinel Hub downloads "
            "(pip install sentinelhub + credentials)."
        ) from e
    return sentinelhub


def build_requests(
    bbox: BBox,
    date: str,
    out_dir: str,
    *,
    modality: str = "S2",
    resolution_m: float = 10.0,
    max_pixels: int = 2500,
):
    """One SentinelHubRequest per split tile (reference :196-260)."""
    sh = _sh()
    deg_res = resolution_m / 111_320.0  # approx deg/px at the equator
    tiles = split_bbox(bbox, deg_res, max_pixels)
    evalscript = EVALSCRIPT_S2 if modality == "S2" else EVALSCRIPT_S1
    collection = (
        sh.DataCollection.SENTINEL2_L1C if modality == "S2"
        else sh.DataCollection.SENTINEL1_IW
    )
    requests = []
    for i, t in enumerate(tiles):
        sh_bbox = sh.BBox(bbox=t, crs=sh.CRS.WGS84)
        size = sh.bbox_to_dimensions(sh_bbox, resolution=resolution_m)
        requests.append(
            sh.SentinelHubRequest(
                evalscript=evalscript,
                input_data=[
                    sh.SentinelHubRequest.input_data(
                        data_collection=collection,
                        time_interval=(date, date),
                    )
                ],
                responses=[
                    sh.SentinelHubRequest.output_response("default", sh.MimeType.TIFF)
                ],
                bbox=sh_bbox,
                size=size,
                data_folder=os.path.join(out_dir, f"tile_{i:04d}"),
            )
        )
    return requests


def download_frame(
    bbox: BBox,
    date: str,
    out_dir: str,
    *,
    modality: str = "S2",
    resolution_m: float = 10.0,
) -> str:
    """Fetch all tiles for one dated frame and merge them into a single
    GeoTIFF mosaic (the reference's VRT+Translate step, done natively)."""
    os.makedirs(out_dir, exist_ok=True)
    for req in build_requests(bbox, date, out_dir, modality=modality,
                              resolution_m=resolution_m):
        req.save_data()
    from ..io.mosaic import merge_tiles

    import numpy as np

    dtype = np.uint16 if modality == "S2" else np.float32
    out = os.path.join(out_dir, f"{modality}_{date}.tif")
    return merge_tiles(out_dir, out, dtype=dtype)
