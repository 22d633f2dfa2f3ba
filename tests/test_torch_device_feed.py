"""The port's device-resident mosaic feed for the eval (popcorn_tpu_torch/
infer/device_feed.py and infer/sliding.py::_run_device_feed_pass) on the
CPU, on the JAX package's tests/test_device_feed.py region (198x204, four
seasons, 128/16 patches, so the bottom border patch starts at x=70):

- its maps are bit-equal to the port's host-feed maps (same patch order,
  same tensors into the same forward, same adds);
- they match the JAX package's device-feed eval at tests/test_torch_eval.py's
  MAP_TOL (rtol 2e-4, atol 2e-5; float32 through both UNets, summed in
  other orders), with equal visit counts and the std maps held through
  their variance as there;
- a season with NaNs in S1 sends only the patch whose window overlaps a NaN
  tile to the host feed, stitched after the device seasons: means at
  rtol/atol 1e-5 against the host-feed run (the JAX test's tolerance; the
  order of the f32 adds differs), counts exact, std maps through their
  variance (``assert_hybrid_close``); with static int8 both routes
  calibrate on the region's first patch;
- device_feed='on' with a host stitch raises."""

import shutil

import jax
import numpy as np
import pytest
import torch

from popcorn_tpu.compat.torch_convert import load_popcorn_from_dda, save_popcorn_checkpoint
from popcorn_tpu.config import ModelConfig as JModelConfig
from popcorn_tpu.data.dataset import PopulationDataset as JDataset
from popcorn_tpu.data.synthetic import make_synthetic_region as j_make
from popcorn_tpu.infer.evaluator import load_member as j_load_member
from popcorn_tpu.infer.sliding import run_sliding_inference as j_run
from popcorn_tpu_torch.config import SEASONS, EvalConfig, ModelConfig
from popcorn_tpu_torch.data.dataset import PopulationDataset
from popcorn_tpu_torch.infer.evaluator import Evaluator, load_member
from popcorn_tpu_torch.infer.sliding import run_sliding_inference
from popcorn_tpu_torch.io.geotiff import GeoTIFF, write_geotiff

torch.set_num_threads(1)
MAP_TOL = dict(rtol=2e-4, atol=2e-5)
HYBRID_TOL = dict(rtol=1e-5, atol=1e-5)
DEVICE_KEYS = {"read_span_s", "upload_span_s", "warmup_s", "n_device_patches"}


def _dataset(cls, paths):
    return cls(paths, "rwa", mode="test", patchsize=128, overlap=16, s1=True, s2=True,
               nir=True, fourseasons=True, train_level="coarse")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    paths = j_make(str(tmp_path_factory.mktemp("devfeed_data")), "rwa", height=198,
                   width=204, seed=31)
    mdir = tmp_path_factory.mktemp("devfeed_members")
    cks = []
    for i in range(2):
        params, consts = load_popcorn_from_dda(JModelConfig(biasinit=0.9407),
                                               head_key=jax.random.PRNGKey(80 + i))
        cks.append(str(mdir / f"m{i}.pth"))
        save_popcorn_checkpoint(cks[-1], params, consts)
    return paths, cks


def _port_run(paths, cks, mcfg=None, **kw):
    members = [load_member(p) for p in cks]
    return run_sliding_inference([m[0] for m in members], members[0][1], mcfg or ModelConfig(),
                                 _dataset(PopulationDataset, paths), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_runs(setup):
    paths, cks = setup
    out = {}
    for feed in ("on", "off"):
        t = {}
        out[feed] = (_port_run(paths, cks, device_feed=feed, timings=t), t)
    return out


def test_device_feed_matches_host_feed(port_runs):
    (dev, t_dev), (host, t_host) = port_runs["on"], port_runs["off"]
    assert t_dev["n_patches"] == t_host["n_patches"] == t_dev["n_device_patches"] == 16
    assert DEVICE_KEYS <= set(t_dev) and not DEVICE_KEYS & set(t_host)
    assert t_dev["upload_s"] > 0 and t_host["upload_s"] == 0.0
    for k in host:
        np.testing.assert_array_equal(dev[k], host[k], err_msg=k)
    assert host["map"].max() > 0


def test_device_feed_matches_jax_device_feed(setup, port_runs):
    paths, cks = setup
    jm = [j_load_member(p) for p in cks]
    ref = j_run([m[0] for m in jm], jm[0][1], JModelConfig(), _dataset(JDataset, paths),
                device_feed="on")
    got = port_runs["on"][0]
    for k in ("map", "scale"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), err_msg=k, **MAP_TOL)
    n = np.asarray(ref["count"], np.float64)
    np.testing.assert_array_equal(got["count"], np.asarray(ref["count"]))
    for mean_k, std_k in (("map", "map_std"), ("scale", "scale_std")):
        var_ref = np.asarray(ref[std_k], np.float64) ** 2
        var_got = np.asarray(got[std_k], np.float64) ** 2
        s2 = (n - 1) * var_ref + n * np.asarray(ref[mean_k], np.float64) ** 2
        bound = 2e-4 * var_ref + 16 * np.finfo(np.float32).eps * s2
        assert (np.abs(var_got - var_ref) <= bound).all(), std_k


def assert_hybrid_close(dev, host):
    """Counts exact, means at HYBRID_TOL, and the std maps through their
    variance at HYBRID_TOL's rtol plus 16 float32 ulps of the sum of
    squares S2 (as tests/test_torch_eval.py holds them): std =
    sqrt((S2 - n*m^2)/(n-1)) cancels where the members agree, so one ulp
    of S2 from another order of adds moves std by about sqrt(eps * S2)."""
    np.testing.assert_array_equal(dev["count"], host["count"])
    n = host["count"].astype(np.float64)
    for mean_k, std_k in (("map", "map_std"), ("scale", "scale_std")):
        np.testing.assert_allclose(dev[mean_k], host[mean_k], err_msg=mean_k, **HYBRID_TOL)
        var_ref = host[std_k].astype(np.float64) ** 2
        var_got = dev[std_k].astype(np.float64) ** 2
        s2 = (n - 1) * var_ref + n * host[mean_k].astype(np.float64) ** 2
        bound = HYBRID_TOL["rtol"] * var_ref + 16 * np.finfo(np.float32).eps * s2
        assert (np.abs(var_got - var_ref) <= bound).all(), std_k


def _nan_paths(setup, tmp_path, season, rows, cols):
    """A copy of the region with NaNs written into one S1 season."""
    paths = setup[0]
    root = str(tmp_path / "nan_data")
    shutil.copytree(paths.root, root)
    from popcorn_tpu_torch.config import DataPaths

    nan_paths = DataPaths(root)
    p = nan_paths.modality_path("rwa", "S1", SEASONS[season])
    with GeoTIFF(p) as g:
        arr, tr = g.read(), g.transform
    arr[:, rows, cols] = np.nan  # < 5% of any patch: the interpolate path
    write_geotiff(p, arr, transform=(tr[0], tr[1], tr[3], tr[5]), nodata=float("nan"))
    return nan_paths


def test_nan_season_takes_the_host_feed_for_its_patch(setup, tmp_path):
    nan_paths = _nan_paths(setup, tmp_path, 1, slice(40, 44), slice(50, 54))
    t_dev = {}
    dev = _port_run(nan_paths, setup[1], device_feed="auto", timings=t_dev)
    host = _port_run(nan_paths, setup[1], device_feed="off")
    n = len(_dataset(PopulationDataset, nan_paths).patch_indices)
    # only the patch overlapping the NaN tile takes the healing path
    assert t_dev["n_patches"] == n and t_dev["n_device_patches"] == n - 1
    assert_hybrid_close(dev, host)


def test_static_int8_calibrates_on_the_first_patch_in_both_routes(setup, tmp_path):
    """NaNs in the first season's window of patch 0: the device route
    heals patch 0 on the host and calibrates on it before its first crop,
    as the host route calibrates on its first batch."""
    nan_paths = _nan_paths(setup, tmp_path, 0, slice(2, 6), slice(3, 7))
    mcfg = ModelConfig(quantize="int8s")
    t_dev = {}
    dev = _port_run(nan_paths, setup[1], mcfg, device_feed="auto", timings=t_dev)
    host = _port_run(nan_paths, setup[1], mcfg, device_feed="off")
    assert t_dev["n_device_patches"] == t_dev["n_patches"] - 1
    assert_hybrid_close(dev, host)


def test_device_feed_on_requires_device_stitch(setup):
    with pytest.raises(ValueError, match="device_feed='on'"):
        _port_run(*setup, device_feed="on", device_stitch="host")
    with pytest.raises(ValueError, match="device_feed="):
        _port_run(*setup, device_feed="yes")


@pytest.mark.parametrize("feed", ["on", "off"])
def test_evaluator_passes_device_feed(setup, tmp_path, feed):
    paths, cks = setup
    ev = Evaluator(paths, ModelConfig(), EvalConfig(checkpoints=tuple(cks), device_feed=feed),
                   device="cpu")
    ev.experiment_folder = str(tmp_path)
    ev.datasets = [_dataset(PopulationDataset, paths)]
    timings = {}
    out = ev.test_target(save=False, timings=timings)
    assert (DEVICE_KEYS <= set(timings["rwa"])) == (feed == "on")
    assert out["Population_AdjCensus_rwa_coarse/r2"] > 0.5
