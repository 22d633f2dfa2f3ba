"""Dated single frames from Sentinel Hub for small AOIs (refugee camps).

Native re-build of the reference's utils/download_sentinelhub.py
(requires the sentinelhub package + credentials). Counterpart of
tools/download_sentinelhub.py.

Example:
  python -m popcorn_tpu_torch.tools.download_sentinelhub --bbox 32.8 4.6 33.0 4.8 \\
      --dates 2021-01-07 2022-01-02 --modality S2 --out-dir frames/
"""

import argparse
import os

from ..acquisition.sentinel_hub import download_frame


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--bbox", nargs=4, type=float, required=True)
    p.add_argument("--dates", nargs="+", required=True)
    p.add_argument("--modality", choices=["S1", "S2"], default="S2")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--resolution", type=float, default=10.0)
    args = p.parse_args(argv)
    for date in args.dates:
        out = download_frame(tuple(args.bbox), date, os.path.join(args.out_dir, date),
                             modality=args.modality, resolution_m=args.resolution)
        print("->", out)


if __name__ == "__main__":
    main()
