"""The port's acquisition modules (popcorn_tpu_torch/acquisition/) against
the JAX package's: tests/test_acquisition.py's network-free cases, each
port function held to the JAX function on the same inputs; the download
clients stay lazy (each module imports without its service's package and
raises ImportError only when a download is asked for); and the tool
twins: merge_tiffs run as ``python -m`` against tools/merge_tiffs.py on the
same raw tiles (mosaics bit-equal), and every twin's --help listing the
JAX tool's flags. No test calls a download service."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from popcorn_tpu.acquisition import common as j_common
from popcorn_tpu.acquisition import mpc as j_mpc
from popcorn_tpu.acquisition import sentinel_hub as j_sentinel_hub
from popcorn_tpu_torch.acquisition import gee, mpc, sentinel_hub
from popcorn_tpu_torch.acquisition.common import retry_submit, season_windows, split_bbox, tile_grid
from popcorn_tpu_torch.config import SEASONS, DataPaths
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
TWINS = ("preprocess_census", "pool_census_grid", "merge_tiffs", "build_raster_cache",
         "download_gee_country", "download_gee_single_frame", "download_mpc_country",
         "download_sentinelhub", "parity_released")


def test_season_windows():
    for year in (2020, 2023):
        assert season_windows(year) == j_common.season_windows(year)
    w = season_windows(2020)
    assert w["spring"] == ("2020-03-01", "2020-06-01")
    assert w["winter"] == ("2020-12-01", "2021-03-01")
    for name in ("CLOUD_FILTER", "CLD_PRB_THRESH", "NIR_DRK_THRESH", "CLD_PRJ_DIST", "BUFFER"):
        assert getattr(gee, name) == getattr(j_common, name)


def test_retry_submit():
    def flaky_after(n):
        calls = []

        def submit():
            calls.append(1)
            if len(calls) < n:
                raise RuntimeError("too many jobs")
        return submit

    for fn in (retry_submit, j_common.retry_submit):
        slept = []
        assert fn(flaky_after(4), sleep=slept.append) == 3
        assert slept == [15.0] * 3

        def always_fails():
            raise RuntimeError("no")

        with pytest.raises(RuntimeError, match="could not submit"):
            fn(always_fails, max_trials=3, sleep=lambda *_: None)


@pytest.mark.parametrize("bbox,res,maxpx", [((0, 0, 1, 1), 1e-4, 2500), ((0, 0, 0.1, 0.1), 1e-4, 2500),
                                            ((28.85, -2.85, 30.9, -1.05), 10 / 111_320.0, 2500),
                                            ((0, 0, 3, 1), 1e-3, 700)])
def test_split_bbox(bbox, res, maxpx):
    tiles = split_bbox(bbox, res, max_pixels=maxpx)
    assert tiles == j_common.split_bbox(bbox, res, max_pixels=maxpx)
    for minx, miny, maxx, maxy in tiles:
        assert (maxx - minx) / res <= maxpx + 1e-9 and (maxy - miny) / res <= maxpx + 1e-9
    area = sum((t[2] - t[0]) * (t[3] - t[1]) for t in tiles)
    assert abs(area - (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])) < 1e-9


def test_tile_grid():
    tiles = tile_grid((0, 0, 2.5, 1.2), 1.0)
    assert len(tiles) == 6
    assert tiles[0] == (0, 0, 1.0, 1.0)
    assert tiles[-1] == (2.0, 1.0, 2.5, 1.2)
    for bbox, deg in (((0, 0, 2.5, 1.2), 1.0), ((28.85, -2.85, 30.9, -1.05), 0.5)):
        assert tile_grid(bbox, deg) == j_common.tile_grid(bbox, deg)


def test_scl_mask_and_median():
    scl = np.array([[0, 4, 8], [9, 10, 5]])
    m = mpc.scl_cloud_mask(scl)
    assert m.tolist() == [[True, False, True], [True, True, False]]
    np.testing.assert_array_equal(m, j_mpc.scl_cloud_mask(scl))
    assert mpc.SCL_CLOUD_CLASSES == j_mpc.SCL_CLOUD_CLASSES and mpc.S2_L2A_BANDS == j_mpc.S2_L2A_BANDS

    stack = np.zeros((3, 1, 2, 2), np.float32)
    stack[0], stack[1], stack[2] = 10, 20, 90
    mask = np.zeros((3, 2, 2), bool)
    mask[2, 0, 0] = True  # the 90 at (0,0) is cloud
    med = mpc.masked_temporal_median(stack, mask)
    assert med[0, 0, 0] == 15.0 and med[0, 0, 1] == 20.0
    mask[:, 1, 1] = True  # all-cloud pixel -> 0
    assert mpc.masked_temporal_median(stack, mask)[0, 1, 1] == 0.0
    rng = np.random.default_rng(2)
    stack = rng.uniform(0, 5000, (5, 4, 9, 11)).astype(np.float32)
    mask = rng.random((5, 9, 11)) < 0.4
    np.testing.assert_array_equal(mpc.masked_temporal_median(stack, mask),
                                  j_mpc.masked_temporal_median(stack, mask))
    x = np.array([-5.0, 3.7, 70000.0, 65535.4, 2.5])
    assert mpc.to_uint16(x).tolist() == [0, 4, 65535, 65535, 2]
    np.testing.assert_array_equal(mpc.to_uint16(x), j_mpc.to_uint16(x))


def test_evalscripts_match():
    assert sentinel_hub.EVALSCRIPT_S2 == j_sentinel_hub.EVALSCRIPT_S2
    assert sentinel_hub.EVALSCRIPT_S1 == j_sentinel_hub.EVALSCRIPT_S1


@pytest.mark.parametrize("client,call", [
    (gee._ee, lambda: gee.download_country("rwa", (28.85, -2.85, 30.9, -1.05))),
    (mpc._stac, lambda: mpc.download_seasonal_composite((0, 0, 1, 1), "spring", "/nonexistent.tif")),
    (sentinel_hub._sh, lambda: sentinel_hub.build_requests((0, 0, 1, 1), "2021-01-07", "/nonexistent")),
], ids=["gee", "mpc", "sentinel_hub"])
def test_clients_import_lazily(client, call, monkeypatch):
    """Without its service's package a download raises ImportError naming
    it, before any network use; the module itself imported without it."""
    for name in ("ee", "pystac_client", "planetary_computer", "sentinelhub", "rasterio"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError, match="install"):
        client()
    with pytest.raises(ImportError):
        call()


def test_merge_tiffs_tool_matches_jax_tool(tmp_path):
    """tests/test_acquisition.py::test_merge_tiffs_tool: raw tiles of an S2
    (uint16) and an S1 (float32, NaN nodata, NaNs inside) season merged by
    the port's tool and by the JAX tool into bit-equal mosaics, equal to
    the array the tiles were cut from; a season without tiles is skipped."""
    rng = np.random.default_rng(0)
    full = {"S2": rng.integers(0, 10000, (4, 64, 96)).astype(np.float32),
            "S1": rng.uniform(-25, 0, (2, 64, 96)).astype(np.float32)}
    full["S1"][1, 5:9, 40:60] = np.nan
    for side in ("port", "jax"):
        paths = DataPaths(str(tmp_path / side))
        for mod, dtype, nodata in (("S2", np.uint16, None), ("S1", np.float32, float("nan"))):
            tdir = paths.raw_tile_dir("rwa", mod, "spring")
            os.makedirs(tdir, exist_ok=True)
            for j, (r0, r1, c0, c1) in enumerate([(0, 64, 0, 37), (0, 30, 37, 96), (30, 64, 37, 96)]):
                write_geotiff(os.path.join(tdir, f"t{j}.tif"), full[mod][:, r0:r1, c0:c1],
                              transform=(10.0 + c0 * 1e-4, 1e-4, 5.0 - r0 * 1e-4, 1e-4),
                              dtype=dtype, nodata=nodata)
    args = ["--region", "rwa"]
    subprocess.run([sys.executable, "-m", "popcorn_tpu_torch.tools.merge_tiffs", "--data_root",
                    str(tmp_path / "port"), *args], check=True, cwd=ROOT, env=ENV, stdout=subprocess.DEVNULL)
    subprocess.run([sys.executable, "tools/merge_tiffs.py", "--data_root", str(tmp_path / "jax"), *args],
                   check=True, cwd=ROOT, env=ENV, stdout=subprocess.DEVNULL)
    for mod, dtype in (("S2", np.uint16), ("S1", np.float32)):
        got, want = (DataPaths(str(tmp_path / side)).modality_path("rwa", mod, "spring")
                     for side in ("port", "jax"))
        with GeoTIFF(got) as g, GeoTIFF(want) as w:
            a, b = g.read(None, raw=True), w.read(None, raw=True)
            assert g.transform == w.transform and a.dtype == b.dtype == dtype
        assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(a.astype(np.float32), full[mod])
    assert not os.path.exists(DataPaths(str(tmp_path / "port")).modality_path("rwa", "S2", SEASONS[1]))


def _flags(help_text):
    return set(re.findall(r"(?<![\w-])(--?[A-Za-z][\w-]*)", help_text)) - {"-h", "--help"}


@pytest.mark.parametrize("name", TWINS)
def test_twin_help_lists_the_jax_tool_flags(name):
    """``python -m popcorn_tpu_torch.tools.<name> --help`` lists every flag of
    tools/<name>.py --help (parity_released adds --device)."""
    port = subprocess.run([sys.executable, "-m", f"popcorn_tpu_torch.tools.{name}", "--help"],
                          cwd=ROOT, env=ENV, capture_output=True, text=True, check=True).stdout
    jax_ = subprocess.run([sys.executable, f"tools/{name}.py", "--help"], cwd=ROOT,
                          env={**ENV, "JAX_PLATFORMS": "cpu"}, capture_output=True, text=True,
                          check=True).stdout
    usage = lambda t: t.split("\n\n")[0]  # noqa: E731  (the usage block lists every flag)
    assert _flags(usage(jax_)) <= _flags(usage(port)), (name, _flags(usage(jax_)) - _flags(usage(port)))
    extra = _flags(usage(port)) - _flags(usage(jax_))
    assert extra == ({"--device"} if name == "parity_released" else set()), extra
