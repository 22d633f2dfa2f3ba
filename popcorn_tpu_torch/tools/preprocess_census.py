"""Census preprocessing: admin polygons + census table -> boundary raster
and census CSV in the PopMapData layout.

Native equivalent of the reference's utils/02_preprocess_rwa_shapefile.py:
matches admin polygons to census rows (by an id column, or by polygon IoU
>= 0.66 between two boundary layers), rasterizes region IDs onto the
Sentinel-2 grid of a template raster, computes each region's bbox and
pixel count, and writes boundaries_<level>.tif + census_<level>.csv.
Reads ESRI shapefiles (pure-python .shp/.dbf reader) or GeoJSON; no
GDAL/geopandas needed. Counterpart of tools/preprocess_census.py.

Example:
  python -m popcorn_tpu_torch.tools.preprocess_census \\
      --boundaries adm.shp --census pop.csv --join-col ADM_ID \\
      --pop-col POP20 --template rwa_S2Aspring.tif \\
      --out-dir $POPCORN_DATA/PopMapData/processed/rwa --level coarse
"""

import argparse
import os

import pandas as pd

from ..geo.rasterize import match_regions_by_iou, rasterize_regions, region_bbox_counts
from ..geo.shapefile import read_vector
from ..io.geotiff import GeoTIFF, write_geotiff


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--boundaries", required=True, help=".shp or .geojson")
    p.add_argument("--census", required=True, help="census CSV")
    p.add_argument("--join-col", default=None,
                   help="attribute column joining polygons to census rows")
    p.add_argument("--census-join-col", default=None,
                   help="census CSV column for the join (default: join-col)")
    p.add_argument("--match-boundaries", default=None,
                   help="optional second polygon layer; polygons are matched "
                        "by IoU>=0.66 instead of an id join")
    p.add_argument("--pop-col", default="POP20")
    p.add_argument("--template", required=True,
                   help="raster defining the target grid (e.g. the S2 mosaic)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--level", default="coarse")
    args = p.parse_args(argv)

    with GeoTIFF(args.template) as g:
        shape = g.shape
        tr = g.transform
        if tr is None:
            raise SystemExit("template has no geotransform")
        t = (tr[0], tr[1], tr[3], tr[5])

    geoms, attrs = read_vector(args.boundaries)
    census = pd.read_csv(args.census)

    if args.match_boundaries:
        geoms_b, attrs_b = read_vector(args.match_boundaries)
        matches = match_regions_by_iou(geoms, geoms_b, shape, t)
        print(f"IoU-matched {len(matches)}/{len(geoms)} polygons")
        jcol = args.census_join_col or args.join_col
        key_of_b = [a.get(jcol) for a in attrs_b]
        rows = []
        for i, j in matches.items():
            sel = census[census[jcol] == key_of_b[j]]
            if len(sel):
                rows.append((i, float(sel.iloc[0][args.pop_col])))
    else:
        jcol = args.join_col
        ccol = args.census_join_col or jcol
        if jcol is None:
            # positional join: polygon order == census row order
            rows = [(i, float(census.iloc[i][args.pop_col])) for i in range(len(geoms))]
        else:
            lut = {r[ccol]: float(r[args.pop_col]) for _, r in census.iterrows()}
            rows = [(i, lut[attrs[i][jcol]]) for i in range(len(geoms))
                    if attrs[i].get(jcol) in lut]

    ids = [i + 1 for i, _ in rows]
    id_raster = rasterize_regions([geoms[i] for i, _ in rows], ids, shape, t)
    bbox_counts = region_bbox_counts(id_raster, ids)

    os.makedirs(args.out_dir, exist_ok=True)
    bpath = os.path.join(args.out_dir, f"boundaries_{args.level}.tif")
    write_geotiff(bpath, id_raster, template=args.template, nodata=0.0)

    out_rows = []
    for (i, pop), rid in zip(rows, ids):
        bbox, count = bbox_counts[rid]
        if bbox is None:
            continue
        out_rows.append({"idx": rid, "POP20": pop, "bbox": bbox, "count": count})
    cpath = os.path.join(args.out_dir, f"census_{args.level}.csv")
    pd.DataFrame(out_rows).to_csv(cpath, index=False)
    print(f"wrote {bpath} and {cpath} ({len(out_rows)} regions)")


if __name__ == "__main__":
    main()
