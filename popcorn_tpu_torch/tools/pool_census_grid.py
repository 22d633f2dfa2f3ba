"""Pool a fine population grid to coarser census evaluation levels.

Native equivalent of the second half of the reference's census
preprocessing (utils/02_preprocess_rwa_shapefile.py:194-327): the Kigali
100 m ground-truth grid is pooled to 200..1000 m cells, and each pooled
cell becomes a census region (boundaries_<level>.tif + census_<level>.csv)
on the same pixel grid as the fine raster. Counterpart of
tools/pool_census_grid.py.

Example:
  python -m popcorn_tpu_torch.tools.pool_census_grid \\
      --fine-grid kigali100_pop.tif --cell-px 10 --factors 2 4 10 \\
      --out-dir $POPCORN_DATA/PopMapData/processed/rwa --prefix kigali
"""

import argparse
import os

import numpy as np
import pandas as pd

from ..geo.rasterize import block_pool_sum
from ..io.geotiff import GeoTIFF, write_geotiff


def pooled_level(pop_fine: np.ndarray, cell_px: int):
    """Aggregate per-pixel population to cells of cell_px x cell_px pixels.

    Returns (cell_pop (Hc,Wc), id_raster (H',W') int ids on the pixel grid,
    rows for the census CSV)."""
    cell_pop = block_pool_sum(pop_fine, cell_px)
    hc, wc = cell_pop.shape
    ids = np.arange(1, hc * wc + 1, dtype=np.float32).reshape(hc, wc)
    id_raster = np.kron(ids, np.ones((cell_px, cell_px), np.float32))
    rows = []
    for i in range(hc):
        for j in range(wc):
            rows.append({
                "idx": int(ids[i, j]),
                "POP20": float(cell_pop[i, j]),
                "bbox": f"[{i * cell_px}, {(i + 1) * cell_px}, "
                        f"{j * cell_px}, {(j + 1) * cell_px}]",
                "count": cell_px * cell_px,
            })
    return cell_pop, id_raster, rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--fine-grid", required=True,
                   help="per-pixel population GeoTIFF (e.g. 100m Kigali grid "
                        "resampled to the S2 pixel grid)")
    p.add_argument("--cell-px", type=int, required=True,
                   help="pixels per cell at the finest level (e.g. 10 = 100m)")
    p.add_argument("--factors", nargs="+", type=int, default=[1],
                   help="multiples of cell-px to emit (1 = the fine level)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--prefix", default="fine")
    args = p.parse_args(argv)

    with GeoTIFF(args.fine_grid) as g:
        pop = g.read(1, squeeze=True)
    os.makedirs(args.out_dir, exist_ok=True)
    for f in args.factors:
        cell = args.cell_px * f
        level = f"{args.prefix}{cell}"
        _, id_raster, rows = pooled_level(pop, cell)
        bpath = os.path.join(args.out_dir, f"boundaries_{level}.tif")
        # id raster truncated to pooled extent; pad back to the fine shape
        full = np.zeros_like(pop, np.float32)
        full[: id_raster.shape[0], : id_raster.shape[1]] = id_raster
        write_geotiff(bpath, full, template=args.fine_grid, nodata=0.0)
        pd.DataFrame(rows).to_csv(os.path.join(args.out_dir, f"census_{level}.csv"), index=False)
        print(f"level {level}: {len(rows)} cells -> {bpath}")


if __name__ == "__main__":
    main()
