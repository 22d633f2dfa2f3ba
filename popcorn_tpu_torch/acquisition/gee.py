"""Google Earth Engine country-scale acquisition.

Native re-build of the reference's GEE downloads
(utils/01_download_gee_country.py and
utils/download_gee_country_single_frame_gaza.py): per-season cloud-free
Sentinel-2 median composites via the s2cloudless + SCL shadow pipeline,
Sentinel-1 VV/VH medians for both orbit passes, Google Open Buildings
exports, and dated single-frame exports for time-series analysis.

The ``ee`` package is imported lazily — everything orchestration-side is
wrapped so environments without Earth-Engine credentials can still import
this module (the pure helpers live in acquisition.common).

Counterpart of popcorn_tpu/acquisition/gee.py, copied with relative imports.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from .common import (
    BUFFER,
    CLD_PRB_THRESH,
    CLD_PRJ_DIST,
    CLOUD_FILTER,
    NIR_DRK_THRESH,
    retry_submit,
    season_windows,
)

S2_EXPORT_BANDS = ["B2", "B3", "B4", "B8"]  # blue, green, red, NIR
S1_BANDS = ["VV", "VH"]


def _ee():
    try:
        import ee
    except ImportError as e:
        raise ImportError(
            "earthengine-api is not installed; GEE acquisition requires it "
            "(pip install earthengine-api + authentication)."
        ) from e
    return ee


def initialize():
    ee = _ee()
    try:
        ee.Initialize()
    except Exception:
        ee.Authenticate(auth_mode="localhost")
        ee.Initialize()
    return ee


# -- cloud-free Sentinel-2 (s2cloudless tutorial pipeline, reference :74-215) --


def s2_collection_with_clouds(ee, aoi, start_date: str, end_date: str):
    """Join S2 TOA with s2cloudless probability and harmonized-SR SCL."""
    s2 = (
        ee.ImageCollection("COPERNICUS/S2")
        .filterBounds(aoi)
        .filterDate(start_date, end_date)
        .filter(ee.Filter.lte("CLOUDY_PIXEL_PERCENTAGE", CLOUD_FILTER))
    )
    scl = (
        ee.ImageCollection("COPERNICUS/S2_SR_HARMONIZED")
        .filterBounds(aoi)
        .filterDate(start_date, end_date)
        .filter(ee.Filter.lte("CLOUDY_PIXEL_PERCENTAGE", CLOUD_FILTER))
        .select("SCL")
    )
    clouds = (
        ee.ImageCollection("COPERNICUS/S2_CLOUD_PROBABILITY")
        .filterBounds(aoi)
        .filterDate(start_date, end_date)
    )
    joined = ee.ImageCollection(
        ee.Join.saveFirst("s2cloudless").apply(
            primary=s2,
            secondary=clouds,
            condition=ee.Filter.equals(
                leftField="system:index", rightField="system:index"
            ),
        )
    )
    return ee.ImageCollection.combine(joined, scl)


def add_cloud_shadow_mask(ee, img):
    """clouds (s2cloudless>60) + projected shadows (dark non-water NIR in
    the solar-azimuth direction), opened and dilated by 60 m."""
    cld_prb = ee.Image(img.get("s2cloudless")).select("probability")
    is_cloud = cld_prb.gt(CLD_PRB_THRESH).rename("clouds")
    img = img.addBands(ee.Image([cld_prb, is_cloud]))

    not_water = img.select("SCL").neq(6)
    dark = (
        img.select("B8")
        .lt(NIR_DRK_THRESH * 1e4)
        .multiply(not_water)
        .rename("dark_pixels")
    )
    azimuth = ee.Number(90).subtract(ee.Number(img.get("MEAN_SOLAR_AZIMUTH_ANGLE")))
    proj = (
        img.select("clouds")
        .directionalDistanceTransform(azimuth, CLD_PRJ_DIST * 10)
        .reproject(crs=img.select(0).projection(), scale=100)
        .select("distance")
        .mask()
        .rename("cloud_transform")
    )
    shadows = proj.multiply(dark).rename("shadows")
    is_cld_shdw = is_cloud.add(shadows).gt(0)
    is_cld_shdw = (
        is_cld_shdw.focalMin(2)
        .focalMax(BUFFER * 2 / 20)
        .reproject(crs=img.select([0]).projection(), scale=20)
        .rename("cloudmask")
    )
    return img.addBands(is_cld_shdw)


def cloud_free_median(ee, aoi, start_date: str, end_date: str):
    col = s2_collection_with_clouds(ee, aoi, start_date, end_date)
    col = col.map(lambda img: add_cloud_shadow_mask(ee, img))
    col = col.map(lambda img: img.select("B.*").updateMask(img.select("cloudmask").Not()))
    return col.median().select(S2_EXPORT_BANDS)


def s1_median(ee, aoi, start_date: str, end_date: str, orbit: str = "DESCENDING"):
    """Seasonal S1 GRD VV/VH median for one orbit pass (reference :313-391)."""
    col = (
        ee.ImageCollection("COPERNICUS/S1_GRD")
        .filterBounds(aoi)
        .filterDate(start_date, end_date)
        .filter(ee.Filter.listContains("transmitterReceiverPolarisation", "VV"))
        .filter(ee.Filter.listContains("transmitterReceiverPolarisation", "VH"))
        .filter(ee.Filter.eq("instrumentMode", "IW"))
        .filter(ee.Filter.eq("orbitProperties_pass", orbit))
        .select(S1_BANDS)
    )
    return col.median()


def export_to_drive(ee, image, description: str, folder: str, region, scale=10,
                    crs="EPSG:4326"):
    task = ee.batch.Export.image.toDrive(
        image=image,
        scale=scale,
        description=description,
        fileFormat="GEOTIFF",
        folder=folder,
        region=region,
        crs=crs,
        maxPixels=80_000_000_000,
    )
    retry_submit(task.start)
    return task


def export_gbuildings(ee, roi, description: str, folder: str,
                      confidence_min: float = 0.0, version: str = "v3"):
    """Google Open Buildings polygon export (reference :394-428).

    Fixes the reference's undefined-variable bug at :461 by passing the
    collection explicitly."""
    col = ee.FeatureCollection(
        f"GOOGLE/Research/open-buildings/{version}/polygons"
    ).filterBounds(roi)
    if confidence_min > 0:
        col = col.filter(ee.Filter.gte("confidence", confidence_min))
    task = ee.batch.Export.table.toDrive(
        collection=col,
        description=description,
        folder=folder,
        fileFormat="GeoJSON",
    )
    retry_submit(task.start)
    return task


def download_country(
    region_name: str,
    bbox: Tuple[float, float, float, float],
    *,
    year: int = 2020,
    folder_prefix: Optional[str] = None,
    seasons: Iterable[str] = ("spring", "summer", "autumn", "winter"),
    with_buildings: bool = True,
):
    """Submit the full per-season export set for one country bbox:
    S2 cloud-free medians, S1 VV/VH desc+asc medians, buildings table."""
    ee = initialize()
    minx, miny, maxx, maxy = bbox
    roi = ee.Geometry.Rectangle([minx, miny, maxx, maxy])
    windows = season_windows(year)
    prefix = folder_prefix or region_name
    tasks = []
    for season in seasons:
        start, end = windows[season]
        tasks.append(
            export_to_drive(
                ee, cloud_free_median(ee, roi, start, end),
                f"{region_name}_S2A{season}", f"{prefix}_S2A{season}", roi,
            )
        )
        for orbit, tag in (("DESCENDING", ""), ("ASCENDING", "Asc")):
            tasks.append(
                export_to_drive(
                    ee, s1_median(ee, roi, start, end, orbit),
                    f"{region_name}_S1{season}{tag}", f"{prefix}_S1{season}{tag}", roi,
                )
            )
    if with_buildings:
        tasks.append(
            export_gbuildings(ee, roi, f"{region_name}_gbuildings", prefix)
        )
    return tasks


def download_single_frames(
    region_name: str,
    bbox: Tuple[float, float, float, float],
    frame_dates: Dict[str, List[str]],
    *,
    folder_prefix: Optional[str] = None,
):
    """Dated single-frame exports for built-up time series (the Gaza
    workflow, download_gee_country_single_frame_gaza.py): one S2 frame per
    date plus the temporally closest S1 frames per orbit.

    frame_dates: {"S2": [iso dates], "S1desc": [...], "S1asc": [...]};
    each date exports the least-cloudy image of [date, date+1day].
    """
    ee = initialize()
    minx, miny, maxx, maxy = bbox
    roi = ee.Geometry.Rectangle([minx, miny, maxx, maxy])
    prefix = folder_prefix or region_name
    tasks = []
    for date in frame_dates.get("S2", []):
        img = (
            ee.ImageCollection("COPERNICUS/S2")
            .filterBounds(roi)
            .filterDate(date, ee.Date(date).advance(1, "day"))
            .sort("CLOUDY_PIXEL_PERCENTAGE")
            .first()
            .select(S2_EXPORT_BANDS)
        )
        tasks.append(
            export_to_drive(ee, img, f"{region_name}_S2_{date}", prefix, roi)
        )
    for key, orbit in (("S1desc", "DESCENDING"), ("S1asc", "ASCENDING")):
        for date in frame_dates.get(key, []):
            img = s1_median(
                ee, roi, date, str(ee.Date(date).advance(1, "day").format("YYYY-MM-dd").getInfo()),
                orbit,
            )
            tasks.append(
                export_to_drive(ee, img, f"{region_name}_S1{orbit[:4]}_{date}", prefix, roi)
            )
    return tasks
