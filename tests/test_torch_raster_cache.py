"""The port's raster-cache sidecar (popcorn_tpu_torch/io/raster_cache.py):
a mosaic replaced while its sidecar is being built must leave a sidecar
that never validates (ROADMAP.md Queue 3 fault 6: the meta took the
source's stat after the decode, pairing the new stat with the old
content), and sidecar reads equal the direct GeoTIFF reader byte for byte
on an unmodified source (both the raw uint16 path and the float path of
data/dataset.py::_RasterSource)."""

import os

import numpy as np
import pytest

from popcorn_tpu_torch.data.dataset import _RasterSource
from popcorn_tpu_torch.io import raster_cache
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff


def _mosaic(path, seed, dtype=np.uint16, shape=(4, 96, 80)):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 10000, shape).astype(dtype)
    write_geotiff(path, data, transform=(0.0, 10.0, 0.0, -10.0), dtype=dtype, tile=32)
    return data


def test_source_replaced_during_build_never_validates(tmp_path, monkeypatch):
    src = str(tmp_path / "S2.tif")
    _mosaic(src, 0)

    class Rewriting(GeoTIFF):
        """The reader, wrapped: the source mosaic is replaced by another
        (a later mtime, other values) while the decode reads it."""

        done = False

        def read(self, *a, **kw):
            out = super().read(*a, **kw)
            if not Rewriting.done:
                Rewriting.done = True
                # a new file moved over the source: the open reader goes on
                # decoding the old one
                _mosaic(src + ".new.tif", 1)
                os.replace(src + ".new.tif", src)
                st = os.stat(src)
                os.utime(src, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
            return out

    monkeypatch.setattr(raster_cache, "GeoTIFF", Rewriting)
    raster_cache.build_cache(src, chunk_rows=32, force=True)
    assert Rewriting.done and os.path.exists(raster_cache.cache_path(src))
    assert raster_cache.open_cache(src) is None
    # the next build, with the source at rest, validates again
    monkeypatch.setattr(raster_cache, "GeoTIFF", GeoTIFF)
    raster_cache.build_cache(src, chunk_rows=32)
    with GeoTIFF(src) as g:
        np.testing.assert_array_equal(raster_cache.open_cache(src), g.read(None, raw=True))


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_sidecar_reads_equal_the_direct_reader(tmp_path, dtype):
    src = str(tmp_path / "m.tif")
    data = _mosaic(src, 2, dtype)
    assert raster_cache.open_cache(src) is None
    raster_cache.build_cache(src, chunk_rows=40)
    mm = raster_cache.open_cache(src)
    assert mm is not None and mm.dtype == dtype
    window = ((7, 90), (3, 77))
    with GeoTIFF(src) as g:
        np.testing.assert_array_equal(mm, g.read(None, raw=True))
        np.testing.assert_array_equal(mm, data)
        direct = g.read((3, 1), window=window)
        direct_raw = g.read((3, 1), window=window, raw=True)
    cached = _RasterSource(src, None, None)
    assert cached._cache is not None
    got = cached.read((3, 1), window)
    assert got.dtype == direct.dtype and got.tobytes() == direct.tobytes()
    raw = cached.read_raw((3, 1), window)
    assert raw.dtype == direct_raw.dtype and raw.tobytes() == direct_raw.tobytes()
