"""The port's geo modules (popcorn_tpu_torch/geo/) and its census tools
against the JAX package's: tests/test_geo.py's offline cases, each port
function held to the JAX function on the same inputs (equal, or bit-equal
rasters), and popcorn_tpu_torch.tools.preprocess_census and
pool_census_grid run as ``python -m`` against tools/preprocess_census.py
and tools/pool_census_grid.py on the same inputs, both by subprocess:
rasters bit-equal, CSV values equal."""

import json
import os
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest

from popcorn_tpu.geo import rasterize as j_rasterize
from popcorn_tpu.geo import shapefile as j_shapefile
from popcorn_tpu_torch.data.dataset import parse_bbox
from popcorn_tpu_torch.geo.rasterize import (
    block_pool_sum,
    match_regions_by_iou,
    rasterize_polygon,
    rasterize_regions,
    region_bbox_counts,
)
from popcorn_tpu_torch.geo.shapefile import polygon_area, read_dbf, read_geojson, read_shp, read_vector
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff
from test_geo import square, write_minimal_shapefile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}


def _run(*cmd):
    subprocess.run([sys.executable, *cmd], check=True, cwd=ROOT, env=ENV,
                   stdout=subprocess.DEVNULL)


def _geoms_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert len(ra) == len(rb)
        for x, y in zip(ra, rb):
            np.testing.assert_array_equal(x, y)


def _raster(path):
    with GeoTIFF(path) as g:
        return g.read(None, raw=True), g.transform, g.nodata


def _same_raster(a, b):
    (xa, ta, na), (xb, tb, nb) = _raster(a), _raster(b)
    assert xa.dtype == xb.dtype and xa.tobytes() == xb.tobytes()
    assert ta == tb and (na == nb or (np.isnan(na) and np.isnan(nb)))


def test_shp_dbf_roundtrip(tmp_path):
    base = str(tmp_path / "poly")
    polys = [square(0, 0, 1), square(2, 0, 1.5)]
    write_minimal_shapefile(base, polys)
    geoms = read_shp(base + ".shp")
    assert len(geoms) == 2
    np.testing.assert_allclose(geoms[0][0], polys[0][0])
    _geoms_equal(geoms, j_shapefile.read_shp(base + ".shp"))
    attrs = read_dbf(base + ".dbf")
    assert [a["ID"] for a in attrs] == [1, 2] and attrs == j_shapefile.read_dbf(base + ".dbf")
    g, a = read_vector(base + ".shp")
    jg, ja = j_shapefile.read_vector(base)
    _geoms_equal(g, jg)
    assert a == ja


def test_geojson_reader(tmp_path):
    gj = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"ID": 7},
         "geometry": {"type": "Polygon", "coordinates": [[[0, 0], [1, 0], [1, 1], [0, 1], [0, 0]]]}},
        {"type": "Feature", "properties": {"ID": 8},
         "geometry": {"type": "MultiPolygon", "coordinates": [
             [[[2, 2], [4, 2], [4, 4], [2, 4], [2, 2]], [[2.5, 2.5], [3, 2.5], [3, 3], [2.5, 2.5]]],
             [[[5, 5], [6, 5], [6, 6], [5, 5]]]]}},
        {"type": "Feature", "properties": {"ID": 9}, "geometry": None},
    ]}
    p = str(tmp_path / "a.geojson")
    json.dump(gj, open(p, "w"))
    geoms, attrs = read_geojson(p)
    assert len(geoms) == 3 and attrs[0]["ID"] == 7 and len(geoms[1]) == 3 and geoms[2] == []
    jg, ja = j_shapefile.read_geojson(p)
    _geoms_equal(geoms, jg)
    assert attrs == ja
    for rings, jrings in zip(geoms[:2], jg[:2]):
        assert polygon_area(rings) == j_shapefile.polygon_area(jrings) > 0


@pytest.mark.parametrize("t", [(0.0, 1.0, 10.0, -1.0), (0.0, 1.0, 0.0, 1.0)],
                         ids=["north_up", "south_up"])
def test_rasterize_square(t):
    # grid: origin (0, 10), 1x1 px, 10x10; square covering x[2,6) y[3,7);
    # the south-up grid (px_h > 0) maps y to rows without the flip
    rings = [np.array([[2, 3], [6, 3], [6, 7], [2, 7]], float)]
    m = rasterize_polygon(rings, (10, 10), t)
    assert m.sum() == 16
    rows = slice(3, 7)
    assert m[rows, 2:6].all()
    np.testing.assert_array_equal(m, j_rasterize.rasterize_polygon(rings, (10, 10), t))


def test_rasterize_with_hole():
    t = (0.0, 1.0, 10.0, -1.0)
    outer = np.array([[1, 1], [9, 1], [9, 9], [1, 9]], float)
    hole = np.array([[4, 4], [6, 4], [6, 6], [4, 6]], float)
    m = rasterize_polygon([outer, hole], (10, 10), t)
    assert m.sum() == 64 - 4
    assert not m[4:6, 4:6].any()
    np.testing.assert_array_equal(m, j_rasterize.rasterize_polygon([outer, hole], (10, 10), t))


def test_rasterize_irregular_polygons_match_jax():
    """Random star-shaped polygons with fractional vertices on a
    geo-referenced grid: the port's scanline fills the JAX package's pixels,
    and the burned id raster is bit-equal."""
    rng = np.random.default_rng(5)
    t = (30.0, 1e-4, -1.5, -1e-4)
    geoms = []
    for _ in range(6):
        c = rng.uniform(0.002, 0.006, 2) * [1, -1] + [30.0, -1.5]
        ang = np.sort(rng.uniform(0, 2 * np.pi, 9))
        r = rng.uniform(4e-4, 1.8e-3, 9)
        geoms.append([np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1)])
    ids = [float(i + 1) for i in range(len(geoms))]
    got = rasterize_regions(geoms, ids, (80, 96), t)
    want = j_rasterize.rasterize_regions(geoms, ids, (80, 96), t)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes() and (got > 0).sum() > 100
    assert region_bbox_counts(got, ids) == j_rasterize.region_bbox_counts(want, ids)


def test_iou_matching():
    t = (0.0, 1.0, 20.0, -1.0)
    a = [square(1, 1, 8), square(11, 1, 8)]
    b = [square(11.5, 1, 8), square(1, 1.5, 8)]  # slightly shifted copies
    matches = match_regions_by_iou(a, b, (20, 20), t)
    assert matches == {0: 1, 1: 0} == j_rasterize.match_regions_by_iou(a, b, (20, 20), t)
    # an IoU below the threshold matches nothing
    assert match_regions_by_iou(a, b, (20, 20), t, threshold=0.99) == {} == \
        j_rasterize.match_regions_by_iou(a, b, (20, 20), t, threshold=0.99)


def test_bbox_counts_and_pool():
    ids = np.zeros((10, 10), np.float32)
    ids[2:5, 3:9] = 4.0
    bc = region_bbox_counts(ids, [4.0, 9.0])
    assert bc[4.0] == ("[2, 5, 3, 9]", 18)
    assert bc[9.0] == (None, 0)
    assert bc == j_rasterize.region_bbox_counts(ids, [4.0, 9.0])
    arr = np.random.default_rng(1).random((9, 14)).astype(np.float32)
    for f in (1, 2, 4):
        p = block_pool_sum(arr, f)
        np.testing.assert_array_equal(p, j_rasterize.block_pool_sum(arr, f))
    assert block_pool_sum(np.arange(16, dtype=np.float32).reshape(4, 4), 2)[0, 0] == 0 + 1 + 4 + 5


def _two_squares(tmp_path):
    gj = {"type": "FeatureCollection", "features": [
        {"type": "Feature", "properties": {"ADM": "a"},
         "geometry": {"type": "Polygon", "coordinates": [[[2, 2], [18, 2], [18, 18], [2, 18], [2, 2]]]}},
        {"type": "Feature", "properties": {"ADM": "b"},
         "geometry": {"type": "Polygon", "coordinates": [[[22, 22], [38, 22], [38, 38], [22, 38], [22, 22]]]}},
        {"type": "Feature", "properties": {"ADM": "c"},
         "geometry": {"type": "Polygon", "coordinates": [[[3, 24], [15, 21], [17, 36], [3, 24]]]}},
    ]}
    bpath = str(tmp_path / "adm.geojson")
    json.dump(gj, open(bpath, "w"))
    cpath = str(tmp_path / "census.csv")
    pd.DataFrame([{"ADM": "b", "POP20": 250.5}, {"ADM": "a", "POP20": 100.0},
                  {"ADM": "c", "POP20": 12.25}]).to_csv(cpath, index=False)
    template = str(tmp_path / "grid.tif")
    write_geotiff(template, np.zeros((40, 40), np.float32), transform=(0.0, 1.0, 40.0, 1.0))
    return bpath, cpath, template


@pytest.mark.parametrize("join", ["id", "positional", "iou"])
def test_preprocess_census_tool_matches_jax_tool(tmp_path, join):
    """tests/test_geo.py::test_preprocess_tool_end_to_end with each join:
    the port's tool and the JAX tool on the same inputs write a bit-equal
    boundary raster and a census CSV with equal idx, bbox, count and
    POP20, whose bboxes and counts agree with the raster."""
    bpath, cpath, template = _two_squares(tmp_path)
    flags = {"id": ["--join-col", "ADM"], "positional": [],
             "iou": ["--join-col", "ADM", "--match-boundaries", bpath]}[join]
    common = ["--boundaries", bpath, "--census", cpath, "--pop-col", "POP20",
              "--template", template, "--level", "coarse", *flags]
    _run("-m", "popcorn_tpu_torch.tools.preprocess_census", *common, "--out-dir", str(tmp_path / "port"))
    _run("tools/preprocess_census.py", *common, "--out-dir", str(tmp_path / "jax"))
    _same_raster(str(tmp_path / "port" / "boundaries_coarse.tif"),
                 str(tmp_path / "jax" / "boundaries_coarse.tif"))
    got, want = (pd.read_csv(tmp_path / side / "census_coarse.csv") for side in ("port", "jax"))
    assert list(got.columns) == list(want.columns) == ["idx", "POP20", "bbox", "count"]
    for col in ("idx", "POP20", "count"):
        assert list(got[col]) == list(want[col])
    assert [parse_bbox(b) for b in got.bbox] == [parse_bbox(b) for b in want.bbox]
    assert len(got) == 3
    if join != "positional":
        assert dict(zip(got.idx, got.POP20)) == {1: 100.0, 2: 250.5, 3: 12.25}
    ids, _, _ = _raster(str(tmp_path / "port" / "boundaries_coarse.tif"))
    for row in got.itertuples():
        r0, r1, c0, c1 = parse_bbox(row.bbox)
        assert (ids[0, r0:r1, c0:c1] == row.idx).sum() == row.count == (ids[0] == row.idx).sum()


def test_pool_census_grid_tool_matches_jax_tool(tmp_path):
    """tests/test_geo.py::test_pool_census_grid_tool: each pooled level's
    boundary raster bit-equal to the JAX tool's and its CSV values equal;
    the cells' populations sum to the fine grid's."""
    rng = np.random.default_rng(3)
    pop = rng.random((40, 60)).astype(np.float32)
    fine = str(tmp_path / "pop.tif")
    write_geotiff(fine, pop, transform=(30.0, 1e-4, -1.5, 1e-4))
    common = ["--fine-grid", fine, "--cell-px", "10", "--factors", "1", "2", "--prefix", "k"]
    _run("-m", "popcorn_tpu_torch.tools.pool_census_grid", *common, "--out-dir", str(tmp_path / "port"))
    _run("tools/pool_census_grid.py", *common, "--out-dir", str(tmp_path / "jax"))
    for level, n in (("k10", 4 * 6), ("k20", 2 * 3)):
        _same_raster(str(tmp_path / "port" / f"boundaries_{level}.tif"),
                     str(tmp_path / "jax" / f"boundaries_{level}.tif"))
        got, want = (pd.read_csv(tmp_path / side / f"census_{level}.csv") for side in ("port", "jax"))
        assert len(got) == n
        for col in ("idx", "POP20", "count", "bbox"):
            assert list(got[col]) == list(want[col])
        np.testing.assert_allclose(got["POP20"].sum(), pop.sum(), rtol=1e-5)
