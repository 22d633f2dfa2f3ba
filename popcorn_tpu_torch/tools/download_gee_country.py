"""Submit GEE exports for one country: seasonal cloud-free S2 composites,
S1 VV/VH medians (both orbits) and Google Open Buildings.

Native re-build of the reference's utils/01_download_gee_country.py
(requires earthengine-api + authentication). Counterpart of
tools/download_gee_country.py.

Example:
  python -m popcorn_tpu_torch.tools.download_gee_country --region rwa \\
      --bbox 28.85 -2.85 30.9 -1.05 --year 2020
"""

import argparse

from ..acquisition.gee import download_country


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", required=True)
    p.add_argument("--bbox", nargs=4, type=float, required=True,
                   metavar=("MINX", "MINY", "MAXX", "MAXY"))
    p.add_argument("--year", type=int, default=2020)
    p.add_argument("--no-buildings", action="store_true")
    args = p.parse_args(argv)
    tasks = download_country(args.region, tuple(args.bbox), year=args.year,
                             with_buildings=not args.no_buildings)
    print(f"submitted {len(tasks)} export tasks")


if __name__ == "__main__":
    main()
