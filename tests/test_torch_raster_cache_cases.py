"""tests/test_raster_cache.py's eight cases against the port's sidecar cache
(popcorn_tpu_torch/io/raster_cache.py) and readers (data/dataset.py's
_RasterSource, the device feeds' uint16 path, the host feed): served
windows byte-equal to the direct reader, staleness, POPCORN_RASTER_CACHE=0,
drop_cache, pickup by the dataset, the uint16 transport through the cache,
and host-feed batches bit-equal with and without sidecars. Each port
sidecar is also held byte-equal to the JAX package's build of the same
source, and popcorn_tpu_torch.tools.build_raster_cache, run as ``python
-m``, against tools/build_raster_cache.py on copies of one region."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from popcorn_tpu.io import raster_cache as j_raster_cache
from popcorn_tpu_torch.config import SEASONS
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff
from popcorn_tpu_torch.io.raster_cache import build_cache, cache_path, drop_cache, open_cache

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def u16_tif(tmp_path):
    rng = np.random.default_rng(3)
    arr = rng.integers(0, 10_000, (4, 96, 130), dtype=np.uint16)
    p = str(tmp_path / "s2.tif")
    write_geotiff(p, arr.astype(np.float32), transform=(30.0, 1e-4, -1.5, 1e-4), dtype=np.uint16)
    return p, arr


@pytest.fixture()
def f32_tif(tmp_path):
    rng = np.random.default_rng(4)
    arr = rng.standard_normal((2, 96, 130)).astype(np.float32)
    arr[0, 5, 7] = np.nan
    p = str(tmp_path / "s1.tif")
    write_geotiff(p, arr, transform=(30.0, 1e-4, -1.5, 1e-4), nodata=float("nan"))
    return p, arr


def _same_as_jax_build(src, tmp_path):
    """The JAX package's sidecar of a copy of ``src`` holds the same bytes."""
    other = str(tmp_path / ("jax_" + os.path.basename(src)))
    shutil.copy(src, other)
    j_raster_cache.build_cache(other)
    a, b = np.load(cache_path(src)), np.load(j_raster_cache.cache_path(other))
    assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


def test_build_and_byte_equality_u16(u16_tif, tmp_path):
    p, arr = u16_tif
    out = build_cache(p)
    assert out == cache_path(p) and os.path.exists(out)
    mm = open_cache(p)
    assert mm is not None and mm.dtype == np.uint16
    np.testing.assert_array_equal(np.asarray(mm), arr)
    # windowed reads byte-equal the direct reader, raw and float paths
    with GeoTIFF(p) as g:
        win = ((10, 60), (17, 101))
        np.testing.assert_array_equal(np.asarray(mm[[2, 0], 10:60, 17:101]),
                                      g.read((3, 1), window=win, raw=True))
        np.testing.assert_array_equal(np.asarray(mm[[0, 1, 2, 3], 10:60, 17:101]).astype(np.float32),
                                      g.read(None, window=win))
    _same_as_jax_build(p, tmp_path)


def test_build_preserves_nan_f32(f32_tif, tmp_path):
    p, arr = f32_tif
    build_cache(p)
    mm = open_cache(p)
    assert mm.dtype == np.float32
    assert np.asarray(mm).tobytes() == arr.tobytes()
    _same_as_jax_build(p, tmp_path)


def test_stale_cache_is_ignored(u16_tif):
    p, arr = u16_tif
    build_cache(p)
    assert open_cache(p) is not None
    # rewrite the source with different content: size/mtime change
    write_geotiff(p, (arr + 1).astype(np.float32), transform=(30.0, 1e-4, -1.5, 1e-4),
                  dtype=np.uint16)
    os.utime(p, ns=(os.stat(p).st_atime_ns, os.stat(p).st_mtime_ns + 10**9))
    assert open_cache(p) is None
    # a rebuild revalidates
    build_cache(p)
    np.testing.assert_array_equal(np.asarray(open_cache(p)), arr + 1)


def test_env_disable(u16_tif, monkeypatch):
    p, _ = u16_tif
    build_cache(p)
    monkeypatch.setenv("POPCORN_RASTER_CACHE", "0")
    assert open_cache(p) is None


def test_drop_cache(u16_tif):
    p, _ = u16_tif
    build_cache(p)
    drop_cache(p)
    assert open_cache(p) is None
    assert not os.path.exists(cache_path(p))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region

    root = str(tmp_path_factory.mktemp("cache_region"))
    return make_synthetic_region(root, "rwa", height=256, width=320, seed=11)


def _cache_region(paths):
    for season in SEASONS:
        for mod in ("S2", "S1"):
            build_cache(paths.modality_path("rwa", mod, season))


def _dataset(paths):
    from popcorn_tpu_torch.data.dataset import PopulationDataset

    return PopulationDataset(paths, "rwa", mode="weaksup", train_level="coarse", patchsize=None,
                             overlap=None, fourseasons=True)


def test_raster_source_serves_from_cache(synth):
    """_RasterSource picks the sidecar up and serves identical windows
    (read and read_raw) to the direct reader."""
    _cache_region(synth)
    ds = _dataset(synth)
    try:
        src = ds._source("S2", 1, False)
        assert src._cache is not None
        win = ((3, 130), (40, 200))
        with GeoTIFF(synth.modality_path("rwa", "S2", "summer")) as g:
            np.testing.assert_array_equal(src.read((3, 2, 1, 4), win), g.read((3, 2, 1, 4), window=win))
            np.testing.assert_array_equal(src.read_raw((3, 2, 1, 4), win),
                                          g.read((3, 2, 1, 4), window=win, raw=True))
        s1 = ds._source("S1", 0, False)
        assert s1._cache is not None
        with GeoTIFF(synth.modality_path("rwa", "S1", "spring")) as g:
            np.testing.assert_array_equal(s1.read((1, 2), win), g.read((1, 2), window=win))
    finally:
        ds.close()


def test_u16_transport_eligibility_through_cache(synth):
    """The uint16 transport path of the device feeds stays eligible when
    windows come from the sidecar instead of the native decoder."""
    from popcorn_tpu_torch.data.device_weaksup import _is_raw_u16_source
    from popcorn_tpu_torch.infer.device_feed import _read_raw_u16

    _cache_region(synth)
    ds = _dataset(synth)
    try:
        src = ds._source("S2", 0, False)
        assert src._cache is not None
        assert _is_raw_u16_source(src)
        raw = _read_raw_u16(src, (3, 2, 1, 4), ((0, 64), (0, 64)))
        assert raw is not None and raw.dtype == np.uint16
        assert not _is_raw_u16_source(ds._source("S1", 0, False))  # float32 mosaic
    finally:
        ds.close()


def test_feed_parity_with_cache(synth, monkeypatch):
    """Host-feed batches are bit-identical with and without sidecars."""
    from popcorn_tpu_torch.data.feed import WeaksupFeed

    def batches():
        ds = _dataset(synth)
        try:
            return list(WeaksupFeed([ds], batch_size=2, seed=1600, prefetch=0).epoch(0))
        finally:
            ds.close()

    _cache_region(synth)
    a = batches()
    monkeypatch.setenv("POPCORN_RASTER_CACHE", "0")
    b = batches()
    assert len(a) == len(b) > 0
    for ba, bb in zip(a, b):
        assert set(ba) == set(bb)
        for k in ba:
            va, vb = np.asarray(ba[k]), np.asarray(bb[k])
            np.testing.assert_array_equal(va, vb, err_msg=k)
            assert va.dtype == vb.dtype, k


def test_build_raster_cache_tool_matches_jax_tool(tmp_path):
    """The port's tool and the JAX tool, each on its own copy of one region
    (with --asc and --all): the same sidecars, byte for byte, each fresh
    and equal to its source's raw read; missing sources are skipped."""
    from popcorn_tpu_torch.data.synthetic import make_synthetic_region

    paths = {side: make_synthetic_region(str(tmp_path / side), "rwa", height=96, width=128, seed=2,
                                         with_ascending=True, with_viirs=True)
             for side in ("port", "jax")}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    flags = ["--region", "rwa", "--asc", "--all"]
    subprocess.run([sys.executable, "-m", "popcorn_tpu_torch.tools.build_raster_cache", "--data_root",
                    paths["port"].root, *flags], check=True, cwd=ROOT, env=env, stdout=subprocess.DEVNULL)
    subprocess.run([sys.executable, "tools/build_raster_cache.py", "--data_root", paths["jax"].root,
                    *flags], check=True, cwd=ROOT, env={**env, "JAX_PLATFORMS": "cpu"},
                   stdout=subprocess.DEVNULL)
    n = 0
    for season in SEASONS:
        for mod, asc in (("S2", False), ("S1", False), ("S1", True)):
            src, other = (paths[s].modality_path("rwa", mod, season, asc) for s in ("port", "jax"))
            mm = open_cache(src)
            with GeoTIFF(src) as g:
                assert mm is not None and np.asarray(mm).tobytes() == g.read(None, raw=True).tobytes()
            assert np.load(cache_path(src)).tobytes() == np.load(cache_path(other)).tobytes()
            n += 1
    viirs = paths["port"].modality_path("rwa", "viirs", "")
    assert open_cache(viirs) is not None
    assert not os.path.exists(cache_path(paths["port"].gbuildings_counts_path("rwa")))
    assert n == 3 * len(SEASONS)
