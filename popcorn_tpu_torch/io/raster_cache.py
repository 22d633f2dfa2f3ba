"""Pre-decoded mmap sidecar cache for mosaic GeoTIFFs.

The hot data plane's cost on a weak host is tile DECODE, not disk: every
windowed read of an LZW/Deflate mosaic inflates whole 256^2 tiles
(io/native/geotiff.cpp), and country-scale eval re-reads overlapping
windows every season. The reference's answer is operational ("use
SSDs", README.md:178); this module pays the decode ONCE:

* :func:`build_cache` decodes a mosaic GeoTIFF into a plain ``.npy``
  sidecar in the file's NATIVE dtype (uint16 for S2, float32 for S1) and
  (C, H, W) layout — self-describing, mmap-able, byte-identical to raw
  reads of the source.
* :func:`open_cache` memory-maps a sidecar when present AND fresh
  (source size+mtime pinned in a tiny JSON meta); windowed reads become
  pure page-cache slices with zero inflate.

The dataset's ``_RasterSource`` (data/dataset.py) picks the sidecar up
automatically; ``tools/build_raster_cache.py`` is the one-time pass over
a region. ``POPCORN_RASTER_CACHE=0`` disables use of sidecars.

Sidecar reads are byte-identical to the direct reader (both the float32
``read`` path and the raw uint16 path).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from .geotiff import GeoTIFF

CACHE_SUFFIX = ".cache.npy"
META_SUFFIX = ".cache.json"
_VERSION = 1


def cache_path(src_path: str) -> str:
    return src_path + CACHE_SUFFIX


def _meta_path(src_path: str) -> str:
    return src_path + META_SUFFIX


def _src_meta(src_path: str) -> dict:
    st = os.stat(src_path)
    return {
        "version": _VERSION,
        "src_size": st.st_size,
        "src_mtime_ns": st.st_mtime_ns,
    }


def enabled() -> bool:
    return os.environ.get("POPCORN_RASTER_CACHE", "1") != "0"


def build_cache(
    src_path: str, *, chunk_rows: int = 2048, force: bool = False
) -> str:
    """Decode ``src_path`` once into its ``.npy`` sidecar (native dtype,
    (C, H, W)); returns the sidecar path. Idempotent unless ``force``.
    Row-chunked so peak RAM is one chunk, and written via a temp file +
    rename so a crashed build never leaves a half-cache that validates.
    """
    out = cache_path(src_path)
    if not force and open_cache(src_path) is not None:
        return out
    # the source's stat BEFORE the decode: a source replaced during the
    # build then no longer matches the meta, so its stale sidecar never
    # validates (the JAX package's copy stats after the decode)
    meta = _src_meta(src_path)
    if os.path.exists(_meta_path(src_path)):
        os.remove(_meta_path(src_path))
    tmp = out + ".tmp"
    with GeoTIFF(src_path) as g:
        mm = np.lib.format.open_memmap(
            tmp, mode="w+", dtype=g.dtype, shape=(g.count, g.height, g.width)
        )
        try:
            for r0 in range(0, g.height, chunk_rows):
                r1 = min(g.height, r0 + chunk_rows)
                mm[:, r0:r1] = g.read(
                    None, window=((r0, r1), (0, g.width)), raw=True
                )
            mm.flush()
        finally:
            del mm
    os.replace(tmp, out)
    # meta last: a crash before this point leaves no meta, so a sidecar
    # never validates without one
    with open(_meta_path(src_path), "w") as f:
        json.dump(meta, f)
    return out


def open_cache(src_path: str) -> Optional[np.memmap]:
    """Memory-mapped (C, H, W) sidecar for ``src_path``, or None when the
    sidecar is absent, stale (source changed since the build), disabled
    via POPCORN_RASTER_CACHE=0, or unreadable."""
    if not enabled():
        return None
    out = cache_path(src_path)
    meta = _meta_path(src_path)
    if not (os.path.exists(out) and os.path.exists(meta)):
        return None
    try:
        with open(meta) as f:
            m = json.load(f)
        if m != _src_meta(src_path):
            return None
        return np.load(out, mmap_mode="r")
    except Exception:
        return None


def drop_cache(src_path: str) -> None:
    for p in (cache_path(src_path), _meta_path(src_path)):
        if os.path.exists(p):
            os.remove(p)
