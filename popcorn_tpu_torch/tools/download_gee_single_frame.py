"""Dated single-frame GEE exports for built-up time-series analysis.

Native re-build of utils/download_gee_country_single_frame_gaza.py:
exports one S2 frame per date plus same/next-day S1 frames per orbit.
Frame dates come from a JSON config {"S2": [...], "S1desc": [...],
"S1asc": [...]}. Counterpart of tools/download_gee_single_frame.py.

Example:
  python -m popcorn_tpu_torch.tools.download_gee_single_frame --region gaza \\
      --bbox 34.2 31.2 34.6 31.6 --frames frames.json
"""

import argparse
import json

from ..acquisition.gee import download_single_frames


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--region", required=True)
    p.add_argument("--bbox", nargs=4, type=float, required=True)
    p.add_argument("--frames", required=True, help="JSON of frame dates")
    args = p.parse_args(argv)
    with open(args.frames) as f:
        frame_dates = json.load(f)
    tasks = download_single_frames(args.region, tuple(args.bbox), frame_dates)
    print(f"submitted {len(tasks)} export tasks")


if __name__ == "__main__":
    main()
