"""Minimal pure-python ESRI Shapefile (.shp/.dbf) and GeoJSON reader.

The reference's census preprocessing reads admin-boundary polygons with
geopandas (utils/02_preprocess_rwa_shapefile.py); neither geopandas nor
shapely exist in this image, so this module implements the small subset
needed: Polygon/MultiPolygon geometry from .shp, attributes from .dbf
(dBase III), and GeoJSON FeatureCollections.

Geometries are returned as lists of rings; each ring is an (N,2) float64
array of (x, y). Ring winding follows the file; the even-odd rasterizer
(geo.rasterize) treats holes correctly without needing winding fixes.

Counterpart of popcorn_tpu/geo/shapefile.py, copied with relative imports.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, List, Tuple

import numpy as np

Ring = np.ndarray  # (N, 2)
PolygonRings = List[Ring]


def read_shp(path: str) -> List[PolygonRings]:
    """Read polygon geometries from a .shp file (shape types 5/15/25)."""
    with open(path, "rb") as f:
        data = f.read()
    code = struct.unpack(">i", data[0:4])[0]
    if code != 9994:
        raise ValueError(f"{path}: not a shapefile")
    geoms: List[PolygonRings] = []
    pos = 100
    n = len(data)
    while pos + 8 <= n:
        (_, content_len) = struct.unpack(">ii", data[pos : pos + 8])
        pos += 8
        rec_end = pos + content_len * 2
        shape_type = struct.unpack("<i", data[pos : pos + 4])[0]
        if shape_type in (5, 15, 25):  # Polygon, PolygonZ, PolygonM
            p = pos + 4 + 32  # skip bbox
            num_parts, num_points = struct.unpack("<ii", data[p : p + 8])
            p += 8
            parts = np.frombuffer(data, "<i4", num_parts, p)
            p += 4 * num_parts
            pts = np.frombuffer(data, "<f8", num_points * 2, p).reshape(-1, 2)
            rings = []
            bounds = list(parts) + [num_points]
            for i in range(num_parts):
                rings.append(np.array(pts[bounds[i] : bounds[i + 1]]))
            geoms.append(rings)
        elif shape_type == 0:  # null shape
            geoms.append([])
        else:
            raise ValueError(f"unsupported shape type {shape_type}")
        pos = rec_end
    return geoms


def read_dbf(path: str) -> List[Dict]:
    """Read attribute records from a dBase III .dbf file."""
    with open(path, "rb") as f:
        data = f.read()
    num_records = struct.unpack("<I", data[4:8])[0]
    header_size, record_size = struct.unpack("<HH", data[8:12])
    fields = []
    pos = 32
    while data[pos] != 0x0D:
        name = data[pos : pos + 11].split(b"\x00")[0].decode("ascii", "replace")
        ftype = chr(data[pos + 11])
        flen = data[pos + 16]
        fdec = data[pos + 17]
        fields.append((name, ftype, flen, fdec))
        pos += 32
    records = []
    pos = header_size
    for _ in range(num_records):
        rec = data[pos : pos + record_size]
        pos += record_size
        if not rec or rec[0:1] == b"*":  # deleted
            continue
        row: Dict = {}
        off = 1
        for name, ftype, flen, fdec in fields:
            raw = rec[off : off + flen]
            off += flen
            s = raw.decode("latin-1").strip()
            if ftype in ("N", "F"):
                if s == "":
                    row[name] = None
                elif ftype == "N" and fdec == 0 and "." not in s:
                    try:
                        row[name] = int(s)
                    except ValueError:
                        row[name] = None
                else:
                    try:
                        row[name] = float(s)
                    except ValueError:
                        row[name] = None
            elif ftype == "L":
                row[name] = s.upper() in ("T", "Y")
            else:
                row[name] = s
        records.append(row)
    return records


def read_shapefile(path: str) -> Tuple[List[PolygonRings], List[Dict]]:
    """Read geometry + attributes ('gdf' equivalent). path may omit .shp."""
    base = path[:-4] if path.lower().endswith(".shp") else path
    geoms = read_shp(base + ".shp")
    try:
        attrs = read_dbf(base + ".dbf")
    except FileNotFoundError:
        attrs = [{} for _ in geoms]
    return geoms, attrs


def _geojson_polygon_rings(coords) -> PolygonRings:
    return [np.asarray(ring, np.float64) for ring in coords]


def read_geojson(path: str) -> Tuple[List[PolygonRings], List[Dict]]:
    """Read Polygon/MultiPolygon features from a GeoJSON file."""
    with open(path) as f:
        gj = json.load(f)
    feats = gj["features"] if gj.get("type") == "FeatureCollection" else [gj]
    geoms, attrs = [], []
    for ft in feats:
        geom = ft.get("geometry") or {}
        t = geom.get("type")
        if t == "Polygon":
            geoms.append(_geojson_polygon_rings(geom["coordinates"]))
        elif t == "MultiPolygon":
            rings: PolygonRings = []
            for poly in geom["coordinates"]:
                rings.extend(_geojson_polygon_rings(poly))
            geoms.append(rings)
        else:
            geoms.append([])
        attrs.append(ft.get("properties", {}))
    return geoms, attrs


def read_vector(path: str) -> Tuple[List[PolygonRings], List[Dict]]:
    if path.lower().endswith((".json", ".geojson")):
        return read_geojson(path)
    return read_shapefile(path)


def polygon_area(rings: PolygonRings) -> float:
    """Even-odd area: sum of |shoelace| with holes subtracted is not
    directly expressible; we use signed areas with even-odd approximated
    by outer-minus-inner ordering (sufficient for matching heuristics)."""
    total = 0.0
    for i, r in enumerate(rings):
        x, y = r[:, 0], r[:, 1]
        a = 0.5 * np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))
        total += a if i == 0 else -a
    return abs(total)
