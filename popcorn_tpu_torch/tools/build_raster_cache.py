"""One-time pre-decode pass: build mmap `.npy` sidecar caches for a
region's mosaics (io/raster_cache.py).

Decodes each LZW/Deflate mosaic GeoTIFF ONCE into an aligned native-dtype
sidecar next to the source; afterwards every windowed read in training and
eval is a zero-inflate mmap slice. The reference's answer to the same
bottleneck is operational ("use SSDs", README.md:178). Counterpart of
tools/build_raster_cache.py.

Example:
  python -m popcorn_tpu_torch.tools.build_raster_cache --region rwa        # S2+S1 seasons
  python -m popcorn_tpu_torch.tools.build_raster_cache --region rwa --all  # + viirs/buildings
"""

import argparse
import os
import time

from ..config import SEASONS, DataPaths
from ..io.raster_cache import build_cache


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", default=None)
    p.add_argument("--region", required=True)
    p.add_argument("--asc", action="store_true", help="also cache ascending S1")
    p.add_argument("--all", action="store_true",
                   help="also cache VIIRS and building rasters")
    p.add_argument("--force", action="store_true", help="rebuild existing caches")
    args = p.parse_args(argv)
    paths = DataPaths(args.data_root)
    targets = []
    for season in SEASONS:
        targets.append(paths.modality_path(args.region, "S2", season))
        targets.append(paths.modality_path(args.region, "S1", season))
        if args.asc:
            targets.append(paths.modality_path(args.region, "S1", season, asc=True))
    if args.all:
        targets.append(paths.modality_path(args.region, "viirs", ""))
        targets.append(paths.gbuildings_counts_path(args.region))
        targets.append(paths.gbuildings_segmentation_path(args.region))
    total = 0
    for src in targets:
        if not os.path.exists(src):
            print(f"skip {src} (missing)")
            continue
        t0 = time.time()
        out = build_cache(src, force=args.force)
        sz = os.path.getsize(out)
        total += sz
        print(f"{src} -> {out} ({sz / 1e6:.0f} MB, {time.time() - t0:.1f}s)")
    print(f"done: {total / 1e9:.2f} GB of sidecars")


if __name__ == "__main__":
    main()
