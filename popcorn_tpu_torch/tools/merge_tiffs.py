"""Merge per-modality raw tile directories into single GeoTIFF mosaics.

Native replacement for the reference's gdal.Warp-based utils/03_merge_tiffs.py
(S2 stored uint16, S1 float32). Walks <raw_ee>/<region>/<modality dirs>.
Counterpart of tools/merge_tiffs.py.

Example:
  python -m popcorn_tpu_torch.tools.merge_tiffs --data_root $POPCORN_DATA --region rwa
"""

import argparse
import os

import numpy as np

from ..config import SEASONS, DataPaths
from ..io.mosaic import merge_tiles


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default=None)
    p.add_argument("--region", required=True)
    p.add_argument("--asc", action="store_true", help="also merge ascending S1")
    args = p.parse_args(argv)
    paths = DataPaths(args.data_root)
    jobs = []
    for season in SEASONS:
        jobs.append(("S2", season, False, np.uint16))
        jobs.append(("S1", season, False, np.float32))
        if args.asc:
            jobs.append(("S1", season, True, np.float32))
    for modality, season, asc, dtype in jobs:
        tile_dir = paths.raw_tile_dir(args.region, modality, season, asc)
        out = paths.modality_path(args.region, modality, season, asc)
        if not os.path.isdir(tile_dir):
            print(f"skip {tile_dir} (missing)")
            continue
        if os.path.exists(out):
            print(f"skip {out} (exists)")
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        print(f"merging {tile_dir} -> {out}")
        merge_tiles(tile_dir, out, dtype=dtype)


if __name__ == "__main__":
    main()
