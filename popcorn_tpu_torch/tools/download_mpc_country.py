"""Auth-free seasonal S2 composites from the Microsoft Planetary Computer.

Native re-build of the reference's utils/01_download_mpc_country.py
(requires pystac-client + planetary-computer + rasterio). Counterpart of
tools/download_mpc_country.py.

Example:
  python -m popcorn_tpu_torch.tools.download_mpc_country --region rwa \\
      --bbox 28.85 -2.85 30.9 -1.05 --out-dir $POPCORN_DATA/...
"""

import argparse
import os

from ..acquisition.mpc import download_seasonal_composite
from ..config import SEASONS


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", required=True)
    p.add_argument("--bbox", nargs=4, type=float, required=True)
    p.add_argument("--year", type=int, default=2020)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--seasons", nargs="+", default=list(SEASONS))
    args = p.parse_args(argv)
    for season in args.seasons:
        out = os.path.join(args.out_dir, f"{args.region}_S2A{season}.tif")
        print("->", download_seasonal_composite(tuple(args.bbox), season, out, year=args.year))


if __name__ == "__main__":
    main()
